"""The diffusion pipelines of the port: pixel-space and latent."""

from d3roma_tpu_torch.guidance import FlowGuidance  # noqa: F401
from d3roma_tpu_torch.pipelines.pipeline import (  # noqa: F401
    GuidedDiffusionPipeline,
    GuidedLatentDiffusionPipeline,
    create_sampler_spec,
)
from d3roma_tpu_torch.pipelines.sampling import (  # noqa: F401
    SAMPLER_KINDS,
    PipelineOutput,
    SamplerSpec,
    latent_decode_images,
    latent_denoise,
    latent_encode_conds,
    pixel_pipeline,
    run_sampler_steps,
)
