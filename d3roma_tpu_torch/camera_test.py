"""Capture latency smoke test.

    python -m d3roma_tpu_torch.camera_test [--replay DIR] [--frames N] [--serial S]

Port of the root `camera_test.py` (reference: camera_test.py:1-44): two
threads pull frames from one source, each printing every frame's shapes and
latency, then the mean latency over both. `--replay DIR` reads a capture
directory through `streaming/sources.py::FileReplaySource` (looping), e.g.
the bundled `assets/examples/`; without it the live RealSense camera
(`RealSenseSource`, which needs pyrealsense2).
"""

from __future__ import annotations

import argparse
import sys
import threading
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.camera_test")
    p.add_argument("--replay", default=None, help="frame dir for FileReplaySource")
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--serial", default=None)
    args = p.parse_args(argv)

    from d3roma_tpu_torch.streaming.sources import FileReplaySource, RealSenseSource

    src = (FileReplaySource(args.replay, loop=True) if args.replay
           else RealSenseSource(args.serial))

    stats = []

    def worker(name):
        it = src.frames()
        for i in range(args.frames):
            t0 = time.time()
            rgb, depth = next(it)
            dt = time.time() - t0
            stats.append(dt)
            print(f"[{name}] frame {i}: {rgb.shape} {depth.shape} {dt*1000:.1f}ms")

    threads = [threading.Thread(target=worker, args=(f"t{i}",)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if not stats:
        raise SystemExit("no frames captured (worker errors above?)")
    print(f"mean latency: {sum(stats)/len(stats)*1000:.2f} ms over {len(stats)} frames")
    src.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
