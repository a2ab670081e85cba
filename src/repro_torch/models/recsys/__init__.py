from .din import DINConfig, din_forward, din_loss, din_param_defs  # noqa: F401
from .embedding import embedding_bag  # noqa: F401
