from .model import (MLAConfig, MoEConfig, TransformerConfig,  # noqa: F401
                    decode_step, forward, init_cache, param_defs,
                    prefill_step)
