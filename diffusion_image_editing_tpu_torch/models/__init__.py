from .bisenet import BiSeNet, SegmentationModel  # noqa: F401
from .extra_blocks import DeeplabV3Head, DenseModule, GlobalAvgPool2d, IdentityResidualBlock  # noqa: F401
from .clip_text import CLIP_VIT_L_14_TEXT, TINY_CLIP_TEXT, CLIPTextConfig, CLIPTextEncoder  # noqa: F401
from .port import (  # noqa: F401
    load_anygan_checkpoint,
    load_bisenet_checkpoint,
    load_checkpoint_dir,
    state_dict_from_jax,
)
from .resnet import NormAct, ResNet50, Resnet18Features  # noqa: F401
from .unet2d import (  # noqa: F401
    DDPM_CELEBAHQ_256,
    LDM_CELEBAHQ_256_UNET,
    TINY_UNET2D,
    UNet2D,
    UNet2DConfig,
)
from .unet2d_cond import (  # noqa: F401
    SD15_UNET,
    SDXL_UNET,
    TINY_SD_UNET,
    TINY_SDXL_UNET,
    SDXLUNetConfig,
    Transformer2D,
    UNet2DCondition,
    UNet2DConditionConfig,
)
from .vae import (  # noqa: F401
    LDM_CELEBAHQ_VQVAE,
    SD_VAE,
    SDXL_VAE,
    TINY_VAE,
    TINY_VQVAE,
    AutoencoderConfig,
    AutoencoderKL,
    Decoder,
    Encoder,
    VectorQuantizer,
    VQModel,
)
