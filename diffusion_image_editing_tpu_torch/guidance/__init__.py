from .attr_functions import (  # noqa: F401
    AttrFunc,
    MultiColorAttrFunc,
    SingleColorAttrFunc,
    color_loss,
    l2_norm,
    single_color_loss,
)
from .registry import AttrFuncRegistry, create_attr_func_registry  # noqa: F401
