"""The bf16 train steps' reading for tests/test_torch_bf16_train*.py: how far
a bf16 step lies from the float32 step of the same weights, draws and
batch, for the port's bf16 step and for JAX's.

A bf16 step cannot be held to another bf16 step element by element: where
one rounding falls the other way (float32 sums in another order), every
later layer's roundings move, and through a network of this depth two bf16
steps' gradients lie about as far apart as either lies from the float32
step (relative L2 ~0.5 on the iDispNet step, JAX's bf16 step against the
port's as much as against float32). What a correct bf16 port shares with
JAX's bf16 step is the size of that distance. So each step is read as its
distance from the float32 step, and the port's is held to JAX's within a
factor on either side (a band), in C19's forms: the losses (relative), the
gradients (relative L2 over all tensors; and per tensor, the share of the
tensors within the band, the rest being the noisiest), and the BatchNorm
running statistics after the step (relative L2 over all of them). A loss
is one number, a mean over few points where few are positive, so its
distance is noisy; one within a bf16 step (2^-8 relative) of JAX's bf16
loss passes too. The float32 step itself lies at distance ~0 from the
gradients and statistics of float32 and fails the band (the control)."""
import numpy as np


def distances(step: dict, ref: dict) -> dict:
    """step and ref: {"loss": {name: float}, "grads": {name: array},
    "stats": {name: array}} -> {"loss": {name: relative difference},
    "grads": relative L2 over all tensors, "per_tensor": {name: relative
    L2}, "stats": relative L2 over all running statistics}."""
    out = {"loss": {k: abs(step["loss"][k] - v) / abs(v) for k, v in ref["loss"].items()},
           "loss_value": dict(step["loss"])}
    for key in ("grads", "stats"):
        num = den = 0.0
        per = {}
        for k, w in ref[key].items():
            g = np.asarray(step[key][k], np.float64)
            w = np.asarray(w, np.float64)
            assert g.shape == w.shape and np.isfinite(g).all(), k
            d2, w2 = ((g - w) ** 2).sum(), (w ** 2).sum()
            num, den = num + d2, den + w2
            per[k] = np.sqrt(d2 / max(w2, 1e-300))
        out[key] = float(np.sqrt(num / max(den, 1e-300)))
        if key == "grads":
            out["per_tensor"] = per
    return out


def in_band(port: dict, jax_: dict, band: float, loss_band: float, share: float) -> list:
    """The failures of the port's distances (distances()) against JAX's: the
    gradients' and statistics' within a factor `band` of JAX's on either
    side, each loss's within `loss_band`, and at least `share` of the
    tensors each within `band` of JAX's distance for it (or both under 1e-3);
    a loss within a bf16 step of JAX's loss passes. -> a list of messages,
    empty when all hold."""
    bad = []

    def check(what, p, j, f):
        if not (j > 0 and j / f <= p <= f * j):
            bad.append(f"{what}: port {p:.4g}, JAX {j:.4g} (band x{f})")

    for k in jax_["loss"]:
        pv, jv = port["loss_value"][k], jax_["loss_value"][k]
        if abs(pv - jv) > 2.0 ** -8 * abs(jv):
            check(f"loss {k}", port["loss"][k], jax_["loss"][k], loss_band)
    check("gradients", port["grads"], jax_["grads"], band)
    check("running statistics", port["stats"], jax_["stats"], band)
    inside = [k for k, j in jax_["per_tensor"].items()
              if max(j, 1e-3) / band <= max(port["per_tensor"][k], 1e-3) <= band * max(j, 1e-3)]
    frac = len(inside) / len(jax_["per_tensor"])
    if frac < share:
        bad.append(f"per tensor: {frac:.3f} of the tensors within x{band}, need {share}")
    return bad


def report(name: str, port: dict, jax_: dict) -> str:
    """One line of the readings (printed with -s)."""
    ratios = np.array([max(port["per_tensor"][k], 1e-3) / max(j, 1e-3)
                       for k, j in jax_["per_tensor"].items()])
    losses = ", ".join(f"{k} port {port['loss'][k]:.3g} JAX {v:.3g}"
                       for k, v in jax_["loss"].items())
    return (f"{name}: distance from the float32 step: {losses}; gradients port "
            f"{port['grads']:.4g} JAX {jax_['grads']:.4g}; statistics port {port['stats']:.4g} "
            f"JAX {jax_['stats']:.4g}; per-tensor ratio quantiles (5, 50, 95%) "
            f"{np.quantile(ratios, [0.05, 0.5, 0.95]).round(3).tolist()} over {len(ratios)}")
