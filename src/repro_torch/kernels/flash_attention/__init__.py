from .ops import MAX_HEAD_DIM, attention, launches  # noqa: F401
from .ref import attention_ref  # noqa: F401
