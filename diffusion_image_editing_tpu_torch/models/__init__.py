from .bisenet import BiSeNet  # noqa: F401
from .port import state_dict_from_jax  # noqa: F401
from .resnet import NormAct, Resnet18Features  # noqa: F401
from .unet2d_cond import SD15_UNET, TINY_SD_UNET, UNet2DCondition, UNet2DConditionConfig  # noqa: F401
from .vae import SD_VAE, TINY_VAE, AutoencoderConfig, AutoencoderKL, Decoder, Encoder  # noqa: F401
