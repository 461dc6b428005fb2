"""The latent diffusion pipeline of the port."""

from d3roma_tpu_torch.pipelines.pipeline import (  # noqa: F401
    GuidanceConfig,
    GuidedLatentDiffusionPipeline,
)
from d3roma_tpu_torch.pipelines.sampling import (  # noqa: F401
    PipelineOutput,
    SamplerSpec,
    latent_decode_images,
    latent_denoise,
    latent_encode_conds,
)
