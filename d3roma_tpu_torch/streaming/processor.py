"""Streaming depth restoration (capture -> denoise -> point clouds).

Port of `d3roma_tpu/streaming/processor.py` (reference: d3roma_processor.py:
24-286, inference_d3roma.py:255-445): a worker thread drains a bounded frame
queue, runs `D3RoMa.infer_with_rgb_raw` (or, with `max_batch > 1`, one
`infer_with_rgb_raw_batch` call for the frames queued together), turns raw
and predicted depth into voxel-downsampled clouds and hands them to a
publisher. ROS is one publisher (`run_ros_node`, which imports rospy and
cv_bridge when called); a callback publisher makes the loop testable.
Frames are resized to the prediction with `utils/resize.py` (OpenCV's
semantics, no OpenCV).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from d3roma_tpu_torch.streaming.realsense import merge_xyz_rgb, rgbd_to_pointcloud
from d3roma_tpu_torch.streaming.sources import FrameSource
from d3roma_tpu_torch.utils.resize import INTER_LINEAR, INTER_NEAREST, resize

logger = logging.getLogger(__name__)


class D3RoMaProcessor:
    """Continuous restoration: frames in, (raw_cloud, pred_cloud) out.

    publish(raw_pc, pred_pc, meta) is called from the worker thread for
    every processed frame; depth_scale_hack reproduces the reference's
    deployment rescale (`pred_depth *= 2.4`, d3roma_processor.py:262),
    default off. With max_batch > 1 the worker drains up to max_batch
    queued frames into one batched pipeline call, padded by repeating the
    last frame so every call has the same batch size.
    """

    def __init__(
        self,
        droma,
        intrinsic: np.ndarray,
        publish: Optional[Callable] = None,
        extrinsic: np.ndarray = np.eye(4),
        voxel_size: float = 0.005,
        queue_size: int = 10,
        depth_scale_hack: float = 1.0,
        max_batch: int = 1,
    ):
        self.droma = droma
        self.intrinsic = intrinsic
        self.extrinsic = extrinsic
        self.publish = publish or (lambda *a, **k: None)
        self.voxel_size = voxel_size
        self.depth_scale_hack = depth_scale_hack
        self.max_batch = int(max_batch)
        self.frame_queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.frames_processed = 0
        self.last_latency_s = None

    def submit(self, rgb: np.ndarray, depth: np.ndarray) -> bool:
        """Enqueue a frame; drops the oldest when full (latency stays
        bounded, as with the reference's maxsize=10 queue). False when a
        frame was dropped."""
        try:
            self.frame_queue.put_nowait((rgb, depth, time.time()))
            return True
        except queue.Full:
            # drop the oldest, then retry a few times: another producer can
            # take the freed slot between our get and put
            for _ in range(4):
                try:
                    self.frame_queue.get_nowait()
                except queue.Empty:
                    pass
                try:
                    self.frame_queue.put_nowait((rgb, depth, time.time()))
                    return False
                except queue.Full:
                    continue
            logger.warning("frame dropped: queue contended")
            return False

    def start(self):
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        logger.info("D3RoMa processor started")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def run_source(self, source: FrameSource, max_frames: Optional[int] = None):
        """Synchronous capture loop over a FrameSource
        (reference: inference_d3roma.py:414-445)."""
        n = 0
        for rgb, depth in source.frames():
            self.process_frame(rgb, depth)
            n += 1
            if max_frames is not None and n >= max_frames:
                break

    def process_frame(self, rgb: np.ndarray, depth: np.ndarray):
        return self.process_frames([(rgb, depth)])[0]

    def process_frames(self, frames):
        """Restore a list of (rgb, depth) frames (one pipeline call when
        max_batch > 1) and publish each frame's (raw_pc, pred_pc)."""
        t0 = time.time()
        n = len(frames)
        if not frames:
            return []
        if self.max_batch == 1:
            preds = [self.droma.infer_with_rgb_raw(rgb, d) for rgb, d in frames]
        else:
            # pad the tail with the last frame, the single frame included, so
            # that every call has one batch size
            batch = frames + [frames[-1]] * (self.max_batch - n)
            preds = self.droma.infer_with_rgb_raw_batch(batch)[:n]

        out = []
        for (rgb, depth), pred_depth in zip(frames, preds):
            pred_depth = pred_depth * self.depth_scale_hack
            h, w = pred_depth.shape[:2]
            rgb_r = resize(rgb, (w, h), interpolation=INTER_LINEAR)
            depth_r = resize(depth, (w, h), interpolation=INTER_NEAREST)
            raw_pc = rgbd_to_pointcloud(rgb_r, depth_r, self.intrinsic, self.extrinsic,
                                        self.voxel_size)
            pred_pc = rgbd_to_pointcloud(rgb_r, pred_depth, self.intrinsic, self.extrinsic,
                                         self.voxel_size)
            self.last_latency_s = time.time() - t0
            self.frames_processed += 1
            self.publish(raw_pc, pred_pc, {"latency_s": self.last_latency_s})
            out.append((raw_pc, pred_pc))
        return out

    def _worker(self):
        """(reference: d3roma_processor.py:248-286)"""
        while not self._stop.is_set():
            try:
                rgb, depth, _ = self.frame_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            frames = [(rgb, depth)]
            while len(frames) < self.max_batch:
                try:
                    r, d, _ = self.frame_queue.get_nowait()
                    frames.append((r, d))
                except queue.Empty:
                    break
            try:
                self.process_frames(frames)
            except Exception:
                logger.exception("frame processing failed")


def run_ros_node(droma, camera, topic_rgb="/cam_right/color/image_raw",
                 topic_depth="/cam_right/aligned_depth_to_color/image_raw"):
    """ROS1 node wiring (reference: d3roma_processor.py:24-86,193-207).
    Needs rospy and cv_bridge."""
    try:
        import rospy
        from cv_bridge import CvBridge
        from sensor_msgs import point_cloud2
        from sensor_msgs.msg import Image, PointCloud2
    except ImportError as e:
        raise ImportError("run_ros_node needs ROS1 (rospy, cv_bridge, sensor_msgs); use "
                          "D3RoMaProcessor with a FrameSource otherwise") from e

    rospy.init_node("d3roma_processor", anonymous=True)
    bridge = CvBridge()
    pub_raw = rospy.Publisher("raw_pcl", PointCloud2, queue_size=10)
    pub_pred = rospy.Publisher("pred_pcl", PointCloud2, queue_size=10)
    fields = _xyzrgb_fields()

    def publish(raw_pc, pred_pc, meta):
        import std_msgs.msg

        header = std_msgs.msg.Header(stamp=rospy.Time.now(), frame_id="camera")
        for pub, (pts, cols) in ((pub_raw, raw_pc), (pub_pred, pred_pc)):
            packed = merge_xyz_rgb(pts, cols if cols is not None else
                                   np.zeros((len(pts), 3), np.uint8))
            pub.publish(point_cloud2.create_cloud(header, fields, packed))

    proc = D3RoMaProcessor(droma, camera.K.arr, publish=publish)
    proc.start()

    state = {}
    # rospy runs each subscriber's callback on its own thread: without the
    # lock two callbacks can both pass the check and the second pop raises
    state_lock = threading.Lock()

    def rgb_cb(msg):
        rgb = bridge.imgmsg_to_cv2(msg, "rgb8")
        with state_lock:
            state["rgb"] = rgb
        maybe()

    def depth_cb(msg):
        depth = bridge.imgmsg_to_cv2(msg, "passthrough").astype(np.float32) / 1000.0
        with state_lock:
            state["depth"] = depth
        maybe()

    def maybe():
        with state_lock:
            if "rgb" in state and "depth" in state:
                pair = (state.pop("rgb"), state.pop("depth"))
            else:
                return
        proc.submit(*pair)

    rospy.Subscriber(topic_rgb, Image, rgb_cb)
    rospy.Subscriber(topic_depth, Image, depth_cb)
    logger.info("D3RoMa ROS node spinning")
    rospy.spin()


def _xyzrgb_fields():
    from sensor_msgs.msg import PointField

    return [
        PointField(name="x", offset=0, datatype=PointField.FLOAT32, count=1),
        PointField(name="y", offset=4, datatype=PointField.FLOAT32, count=1),
        PointField(name="z", offset=8, datatype=PointField.FLOAT32, count=1),
        PointField(name="rgb", offset=12, datatype=PointField.UINT32, count=1),
    ]
