"""Helpers of the bf16 tests (tests/test_torch_bf16.py, whose docstring
states the parity rules, and tests/test_torch_bf16_{modules,steps,policy}.py):
the configurations, the parity checks, JAX's SpatialSoftmax on the port's
grid, each preset's models with one set of JAX's weights, and the train
step's losses and gradients against JAX's."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _make_raw_batch
from hulc_tpu import config as jax_config
from hulc_tpu.training.preprocess import preprocess_batch as jax_preprocess_batch
from hulc_tpu.training.torch_convert import convert_state_dict

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.models.hulc import LOSS_KEYS
from tests.torch_port_common import jax_random_params, port_model_from_jax

B, S, KL_BETA, LANES = 3, 4, 0.01, 3
PARITY_ABS = 1e-2  # d_port's ceiling for a forward output
PARITY_SHARE = 0.5  # d_port's ceiling as a share of d_ref, module by module
CHAOS_SHARE = 1.5  # end to end and backward: about sqrt(2), two independent roundings
# where bf16 moves an output by less, the fp32 tests' own tolerance against JAX
LOSS_FLOOR = 1e-5  # tests/test_torch_train_step.py's and test_torch_validation.py's loss rtol
GRAD_FLOOR = 1e-4  # tests/test_torch_train_step.py's per-leaf relative L2
# a gradient is also held to twice its sensitivity (chip_smoke.py's
# compare_train_plain): d_sens is the largest change of JAX's bf16 gradient
# when the perceptual encoders' LayerNorm scales move by 2^-10 (random
# signs, SENS_PATTERNS patterns), a quarter of a bf16 ulp and some 20x the
# port's distance from JAX at the perceptual embedding (about 5e-5): such
# noise switches the relu units at zero that the port's roundings switch.
# Its distribution is lumpy (each switch adds a step): on hulc_debug's plan
# proposal 16 patterns gave three levels, 0.003-0.006, 0.009-0.013 and
# 0.018-0.031, the top one 3 times in 16, so 4 patterns miss it about
# half the time; as chip_smoke.py's ULP_PATTERNS, 16
SENS_SHARE, SENS_NOISE, SENS_PATTERNS = 2.0, 2.0**-10, 16
BF16_SHARE = 0.5  # the median d(port, JAX fp32) / d_ref of a case, at least


def bf16_cfg(m, name, dtype):
    cfg = m.get_config(name, replan_freq=3, compute_dtype=dtype)
    pe = cfg.perceptual_encoder
    pe = dataclasses.replace(pe, rgb_gripper=dataclasses.replace(pe.rgb_gripper, input_size=84))
    pr = dataclasses.replace(cfg.plan_recognition, dropout=0.0)
    return dataclasses.replace(cfg, perceptual_encoder=pe, plan_recognition=pr).resolve()


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(x, np.float64)


def rel_l2(a, b) -> float:
    a, b = as_np(a), as_np(b)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den > 0 else float(np.linalg.norm(a - b))


def check_parity(name, port, jax_bf16, jax_fp32, share=PARITY_SHARE, cap=PARITY_ABS, floor=0.0, d_sens=0.0):
    """``d_port <= max(share * d_ref, SENS_SHARE * d_sens, floor)`` (and
    ``<= cap`` unless None) on one output; returns (d_port, d_ref,
    d(port, JAX fp32))."""
    d_port, d_ref = rel_l2(port, jax_bf16), rel_l2(jax_bf16, jax_fp32)
    if cap is not None:
        assert d_port <= cap, f"{name}: d_port {d_port:.3g} above {cap}"
    assert d_port <= max(share * d_ref, SENS_SHARE * d_sens, floor), (
        f"{name}: d_port {d_port:.3g} above {share} x d_ref {d_ref:.3g} and {SENS_SHARE} x d_sens {d_sens:.3g}")
    return d_port, d_ref, rel_l2(port, jax_fp32)


def check_bf16(name, rows):
    """The median of d(port, JAX fp32) / d_ref over a case's outputs (those
    bf16 moves) is at least BF16_SHARE: the port computes in bf16. Prints
    the case's d_port / d_ref (``pytest -s``)."""
    ratios = [d32 / d_ref for _, d_ref, d32 in rows if d_ref > 0]
    assert ratios and np.median(ratios) >= BF16_SHARE, f"median d(port, JAX fp32) / d_ref {np.median(ratios):.3g}"
    port = [d_port / d_ref for d_port, d_ref, _ in rows if d_ref > 0]
    print(f"{name}: {len(rows)} outputs, d_port / d_ref median {np.median(port):.3g}, largest {max(port):.3g}, "
          f"{sum(r > PARITY_SHARE for r in port)} above {PARITY_SHARE}, {sum(r > CHAOS_SHARE for r in port)} above "
          f"{CHAOS_SHARE}; d(port, JAX fp32) / d_ref median {np.median(ratios):.3g}")


@contextlib.contextmanager
def jax_grid_of_the_port():
    """JAX's SpatialSoftmax, while traced inside, on ``torch.linspace``'s
    grid instead of ``jnp.linspace``'s (they differ by an ulp in some
    entries): a second reference that differs from JAX's by that
    definition alone (tests/test_torch_bf16.py's docstring). The JAX
    package's files are left as they are."""
    import hulc_tpu.models.vision as jax_vision

    class _Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def linspace(start, stop, num):
            return jnp.asarray(torch.linspace(float(start), float(stop), int(num)).numpy())

    saved, jax_vision.jnp = jax_vision.jnp, _Jnp()
    try:
        yield
    finally:
        jax_vision.jnp = saved


def bf16_setup(name, seed):
    """JAX's bf16 and fp32 models of ``name`` with one set of random weights,
    a raw {"vis", "lang"} batch of B windows of S frames, and the port's
    bf16 model holding the weights."""
    jax_cfgs = {dt: bf16_cfg(jax_config, name, dt) for dt in ("bfloat16", "float32")}
    cfg = bf16_cfg(port_config, name, "bfloat16")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfgs["bfloat16"])
    jax_models, params = {}, None
    for dt, jc in jax_cfgs.items():
        jax_models[dt], params = jax_random_params(jc, seed=seed)
    raw = _make_raw_batch(jax_cfgs["float32"], B, S, seed=seed + 1)
    raw["lang"] = raw["lang"]._replace(use_for_aux_lang_loss=np.array([True, False, True]))
    model, unused = port_model_from_jax(params, cfg)
    assert unused == []
    return {"jax_cfgs": jax_cfgs, "cfg": cfg, "jax_models": jax_models, "params": params, "raw": raw, "model": model}


def layer_norm_noise(params, seed):
    """``params`` with the perceptual encoders' LayerNorm scales moved by
    +-SENS_NOISE (relative, random signs)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.array, params)
    for enc in params["perceptual_encoder"].values():
        enc["ln"]["scale"] = (enc["ln"]["scale"] * (1 + SENS_NOISE * rng.choice([-1.0, 1.0], enc["ln"]["scale"].shape))
                              ).astype(np.float32)
    return params


def jax_train(setup, key, prep_key, batch, train, port_grid=False):
    """JAX's losses and gradient tree in bf16 and in fp32, by dtype, and in
    bf16 under each of SENS_PATTERNS LayerNorm noises ("sensitivity"); with
    ``port_grid``, also in bf16 on the port's SpatialSoftmax grid
    ("port_grid", ``jax_grid_of_the_port``)."""
    out = {}
    for dt, jax_model in setup["jax_models"].items():
        prep = jax_preprocess_batch(setup["jax_cfgs"][dt], batch, rng=prep_key, train=train)

        def loss_fn(p, prep=prep, jax_model=jax_model):
            losses = jax_model.apply({"params": p}, key, prep, KL_BETA, method=jax_model.train_losses)
            return losses["total_loss"], losses

        fn = jax.jit(jax.grad(loss_fn, has_aux=True))
        grads, losses = jax.device_get(fn(setup["params"]))
        out[dt] = (losses, grads)
        if dt == "bfloat16":
            out["sensitivity"] = [jax.device_get(fn(layer_norm_noise(setup["params"], seed))[0])
                                  for seed in range(SENS_PATTERNS)]
            if port_grid:
                with jax_grid_of_the_port():  # a new function, traced inside (JAX caches loss_fn's trace)
                    fn = jax.jit(jax.grad(lambda p, loss_fn=loss_fn: loss_fn(p), has_aux=True))
                    grads, losses = jax.device_get(fn(setup["params"]))
                out["port_grid"] = (losses, grads)
    return out


def check_train(name, setup, got, model, want):
    """Every loss and gradient by the parity rule against the JAX package;
    with ``want["port_grid"]``, also against JAX on the port's grid, and
    the grid's own effect on JAX's gradients (d_grid) printed."""
    keys = set(LOSS_KEYS) | {f"{k}_{s}" for k in ("action_loss", "kl_loss_scaled", "total_loss")
                             for s in ("vis", "lang")}
    assert keys <= set(got)
    refs = {"bfloat16": "JAX", "port_grid": "JAX on the port's grid"}
    refs = {dt: ref for dt, ref in refs.items() if dt in want}
    rows = {dt: [] for dt in refs}
    for k in sorted(keys):
        if float(want["float32"][0][k]) == 0.0:  # a loss the config turns off
            assert float(got[k]) == 0.0 == float(want["bfloat16"][0][k]), k
            continue
        for dt in refs:
            rows[dt].append(check_parity(k, got[k], want[dt][0][k], want["float32"][0][k], CHAOS_SHARE,
                                         floor=LOSS_FLOOR))
    port_grads, unused = convert_state_dict({k: p.grad.numpy() for k, p in model.named_parameters()},
                                            setup["jax_cfgs"]["float32"])
    assert unused == []
    flat = lambda t: [v for _, v in jax.tree_util.tree_flatten_with_path(t)[0]]
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(want["bfloat16"][1])[0]]
    assert paths == [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(port_grads)[0]]
    grid = flat(want["port_grid"][1]) if "port_grid" in want else [None] * len(paths)
    d_grids = []
    for path, g, w16, w32, wg, *noised in zip(paths, flat(port_grads), flat(want["bfloat16"][1]),
                                               flat(want["float32"][1]), grid, *map(flat, want["sensitivity"])):
        d_sens = max(rel_l2(n, w16) for n in noised)
        d_grid = 0.0 if wg is None else rel_l2(wg, w16)
        d_grids.append(d_grid)
        rows["bfloat16"].append(check_parity(path, g, w16, w32, CHAOS_SHARE, cap=None, floor=GRAD_FLOOR,
                                             d_sens=d_sens))
        if wg is not None:
            rows["port_grid"].append(check_parity(f"{path} (JAX on the port's grid)", g, wg, w32, CHAOS_SHARE,
                                                  cap=None, floor=GRAD_FLOOR, d_sens=d_sens))
    for dt, ref in refs.items():
        check_bf16(f"{name} against {ref}", rows[dt])
    if "port_grid" in want:
        print(f"{name}: the grid's own effect on JAX's bf16 gradients, d_grid, up to {max(d_grids):.3g} "
              f"({paths[int(np.argmax(d_grids))]})")
    return len(paths)
