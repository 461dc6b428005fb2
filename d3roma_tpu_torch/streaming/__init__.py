"""Streaming and serving: frame sources, micro-batching, the HTTP front end,
the continuous processor and the startup probe (port of
`d3roma_tpu/streaming/`)."""

from d3roma_tpu_torch.streaming.batcher import MicroBatcher  # noqa: F401
from d3roma_tpu_torch.streaming.http_server import InferenceHTTPServer  # noqa: F401
from d3roma_tpu_torch.streaming.processor import D3RoMaProcessor  # noqa: F401
from d3roma_tpu_torch.streaming.realsense import (  # noqa: F401
    RealSenseRGBDCamera,
    crop_workspace,
    merge_xyz_rgb,
    rgbd_to_pointcloud,
)
from d3roma_tpu_torch.streaming.sources import (  # noqa: F401
    FileReplaySource,
    FrameSource,
    RealSenseSource,
)
