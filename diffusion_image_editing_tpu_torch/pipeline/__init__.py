from .edit_pipeline import EditorOutput, EditPipeline  # noqa: F401
from .factory import (  # noqa: F401
    create_diffusion_model,
    create_segmentation_model,
    get_pretrained_anygan,
    load_wrapper_params,
    save_wrapper_params,
)
from .masks import MaskCreator, apply_mask  # noqa: F401
from .wrappers import DDPM, LDM, SD, SDXL, DiffusionWrapper, SDXLText  # noqa: F401
