"""Models of the port: the SD2.1-geometry UNet, the SD VAE, their layers
and the weight bridge from the JAX package's Flax trees."""

from d3roma_tpu_torch.models.convert import (  # noqa: F401
    flax_unet_to_torch,
    flax_vae_to_torch,
    init_random_,
)
from d3roma_tpu_torch.models.unet2d_condition import (  # noqa: F401
    UNet2DCondition,
    widened_in_channels,
)
from d3roma_tpu_torch.models.vae import (  # noqa: F401
    SD_LATENT_SCALE,
    AutoencoderKL,
    decode_latent,
    encode_disp_to_latent,
    encode_image_to_latent,
)
