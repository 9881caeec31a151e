from .bisenet import BiSeNet, SegmentationModel  # noqa: F401
from .clip_text import CLIP_VIT_L_14_TEXT, TINY_CLIP_TEXT, CLIPTextConfig, CLIPTextEncoder  # noqa: F401
from .port import load_bisenet_checkpoint, load_checkpoint_dir, state_dict_from_jax  # noqa: F401
from .resnet import NormAct, Resnet18Features  # noqa: F401
from .unet2d_cond import SD15_UNET, TINY_SD_UNET, UNet2DCondition, UNet2DConditionConfig  # noqa: F401
from .vae import SD_VAE, TINY_VAE, AutoencoderConfig, AutoencoderKL, Decoder, Encoder  # noqa: F401
