"""The five LM architectures the repo supports, copied from the JAX
package's ``configs/lm_archs.py`` with the port's config classes.

The optimizer name beside each config is the training choice of the
reference (adamw for the dense models, adafactor for the two MoEs).  All
five run in the port; on one card the two MoE models serve at full width
and a cut depth (``chip_smoke.py``).  :data:`LONG_CONTEXT_OK` and
:data:`TRAIN_ACCUM` are the reference's, for the dry run's cells
(``configs/registry.py``).
"""
from __future__ import annotations

from ..models.transformer import MLAConfig, MoEConfig, TransformerConfig

# yi-34b [arXiv:2403.04652]: llama-arch GQA, 60L d=7168 56H kv=8 ff=20480
YI_34B = TransformerConfig(
    name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    head_dim=128, d_ff=20480, vocab=64000, rope_theta=5e6, norm_eps=1e-5)

# stablelm-12b [hf:stabilityai/stablelm-2-12b]: 40L d=5120 32H kv=8 ff=13824
STABLELM_12B = TransformerConfig(
    name="stablelm-12b", n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    head_dim=160, d_ff=13824, vocab=100352, rope_theta=1e4, norm_eps=1e-5)

# gemma3-1b [hf:google/gemma-3-1b-pt]: 26L d=1152 4H kv=1, 5:1 local:global
# (window 512), dual RoPE bases, tied 262k vocab, sqrt(d) embed scale
GEMMA3_1B = TransformerConfig(
    name="gemma3-1b", n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    head_dim=256, d_ff=6912, vocab=262144, rope_theta=1e4,
    rope_theta_global=1e6, window=512, local_global_pattern=5,
    tied_embeddings=True, embed_scale=True, rmsnorm_plus_one=True,
    logit_softcap=30.0)

# deepseek-v3-671b [arXiv:2412.19437]: MLA, 61L d=7168 128H, 3 dense layers
# then 1 shared + 256 routed experts (d_ff=2048) top-8, sigmoid aux-free
# router, MTP, vocab 129280
DEEPSEEK_V3_671B = TransformerConfig(
    name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
    n_kv_heads=128, head_dim=128, d_ff=18432, vocab=129280,
    rope_theta=1e4, n_dense_layers=3, mtp=True,
    mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
                  v_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  capacity_factor=1.25, router="sigmoid_aux_free"))

# arctic-480b [hf:Snowflake/snowflake-arctic-base]: 35L d=7168 56H kv=8,
# dense residual FFN (d_ff=4864 per assignment) ∥ 128-expert top-2 MoE
ARCTIC_480B = TransformerConfig(
    name="arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    head_dim=128, d_ff=4864, vocab=32000, rope_theta=1e4,
    moe_dense_parallel=True,
    moe=MoEConfig(n_experts=128, top_k=2, d_expert=4864,
                  capacity_factor=1.25, router="softmax"))

LM_ARCHS = {
    "yi-34b": (YI_34B, "adamw"),
    "stablelm-12b": (STABLELM_12B, "adamw"),
    "gemma3-1b": (GEMMA3_1B, "adamw"),
    "deepseek-v3-671b": (DEEPSEEK_V3_671B, "adafactor"),
    "arctic-480b": (ARCTIC_480B, "adafactor"),
}

# long_500k applicability (the reference's DESIGN.md §4): needs a
# sub-quadratic/compressed KV path. gemma3 (5:1 sliding window) and
# deepseek (MLA latent cache) run; pure full-attention GQA archs skip.
LONG_CONTEXT_OK = {"gemma3-1b", "deepseek-v3-671b"}

# gradient-accumulation microbatching for train_4k, as the reference sized
# it (so the big-vocab CE logits and saved activations fit 16 GB a TPU
# device); the dry run's training cells step with it
TRAIN_ACCUM = {"gemma3-1b": 4, "deepseek-v3-671b": 8, "arctic-480b": 4,
               "yi-34b": 2, "stablelm-12b": 2}


def reduced_lm(cfg: TransformerConfig) -> TransformerConfig:
    """Smoke-test scale: same family/topology, tiny dims."""
    import dataclasses
    moe = cfg.moe
    if moe is not None:
        # capacity_factor large enough that no token ever drops — keeps the
        # prefill/decode consistency check exact at smoke scale
        moe = dataclasses.replace(moe, n_experts=4,
                                  top_k=min(moe.top_k, 2), d_expert=32,
                                  capacity_factor=8.0)
    mla = cfg.mla
    if mla is not None:
        mla = MLAConfig(q_lora=32, kv_lora=16, qk_nope=8, qk_rope=8, v_dim=8)
    return dataclasses.replace(
        cfg, n_layers=4 if cfg.n_dense_layers == 0 else 5,
        n_dense_layers=min(cfg.n_dense_layers, 1),
        d_model=64, n_heads=4, n_kv_heads=max(1, cfg.n_kv_heads // 14),
        head_dim=16, d_ff=128, vocab=256, window=cfg.window and 8,
        moe=moe, mla=mla)
