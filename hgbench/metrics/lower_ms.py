"""Lowering time a request: a singlepoint plan turned into packed
``(adds, dels)`` planes on the device and the results back as masks.  The
spans cover ``plan_to_chain`` (payload fetches and decoding inside it),
the bitmap packing and unpacking (``core/bitmaps.py``:
``np_from_indices``, ``np_pack``, ``np_unpack``, ``to_numpy_words``) and
the host-to-device copies (``_to_device``); nested calls count once."""

SOURCE = "program_span"
_EXEC = "repro_torch.runtime.torch_exec"
_BITS = "repro_torch.core.bitmaps"
WRAPS = ((_EXEC, "plan_to_chain", "lower"),
         (_EXEC, "_to_device", "lower"),
         (_BITS, "np_from_indices", "lower"),
         (_BITS, "np_pack", "lower"),
         (_BITS, "np_unpack", "lower"),
         (_BITS, "to_numpy_words", "lower"))


def read(trace):
    if not trace.requests or not trace.spans.get("lower"):
        return None
    return trace.span_s("lower") / trace.requests * 1e3
