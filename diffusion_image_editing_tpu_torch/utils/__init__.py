from .constants import ANY_GAN_ATTRS, ANY_GAN_ATTRS_DICT, ATTR_DICT, ATTRS  # noqa: F401
