from .edit_pipeline import EditorOutput, EditPipeline  # noqa: F401
from .wrappers import SD  # noqa: F401
