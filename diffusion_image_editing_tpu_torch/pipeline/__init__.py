from .edit_pipeline import EditorOutput, EditPipeline  # noqa: F401
from .factory import create_diffusion_model  # noqa: F401
from .masks import apply_mask  # noqa: F401
from .wrappers import SD  # noqa: F401
