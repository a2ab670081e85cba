"""``delta_apply_fused``'s share of its roofline: the least time of the
problems the retrieval handed the kernel (``torch_exec`` calls
``delta_apply_fused_pair``: both planes, the node plane with weights,
both with the live indicator), over the kernel's device time in the
trace."""

from hgbench import roofline

SOURCE = "device_trace"


def _shape(base_n, adds_n, dels_n, base_e, adds_e, dels_e, weights_n=None,
           weights_e=None, **kw):
    return (adds_n.shape[0], adds_n.shape[1], adds_e.shape[1],
            0 if weights_n is None else int(weights_n.numel()),
            0 if weights_e is None else int(weights_e.numel()),
            kw.get("emit_live", True))


WRAPS = (("repro_torch.runtime.torch_exec", "delta_apply_fused_pair",
          "launch.delta_apply_fused", _shape),)


def read(trace):
    calls = trace.calls.get("launch.delta_apply_fused")
    device_s = trace.device_s("delta_apply_fused_kernel")
    if not calls or device_s <= 0:
        return None
    least = 0.0
    for K, W_n, W_e, w_n, w_e, live in calls:
        b_n, o_n = roofline.fused_plane_work(K, W_n, w_n, live)
        b_e, o_e = roofline.fused_plane_work(K, W_e, w_e, live)
        least += roofline.least_s(b_n + b_e, o_n + o_e)
    return 100.0 * least / device_s
