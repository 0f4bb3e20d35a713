"""bf16 compute in the port, module by module, against the JAX package on
the CPU: each module of the bf16 path (both camera encoders, both goal
encoders, the plan proposal, the recognition transformer, the decoder,
the CLIP head and loss) at ``hulc_debug`` (tests/torch_bf16_common.py's
configuration), on the same inputs and weights as its JAX counterpart in
bf16 and in fp32: every output within min(1e-2, 0.5 d_ref) of JAX's bf16
output, the inputs' gradient within 1.5 d_ref (tests/test_torch_bf16.py's
docstring has the rules and their reasons)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hulc_tpu.training.preprocess import preprocess_batch as jax_preprocess_batch

from tests.torch_bf16_common import (
    B,
    CHAOS_SHARE,
    S,
    bf16_setup,
    check_bf16,
    check_parity,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hulc_setup():
    return bf16_setup("hulc_debug", seed=84)


# module by module, on the same inputs: (the JAX module of a config and
# dtype, its parameters' path, the port's module, the inputs, the JAX
# forward to a tuple of outputs, the port's)
def _modules(setup):
    from hulc_tpu.models.aux_heads import ProjVisLang as JaxProjVisLang
    from hulc_tpu.models.decoders import make_action_decoder
    from hulc_tpu.models.goal_encoders import GoalEncoder as JaxGoalEncoder
    from hulc_tpu.models.goal_encoders import make_language_goal_encoder
    from hulc_tpu.models.hulc import masked_clip_loss as jax_clip_loss
    from hulc_tpu.models.plan_nets import PlanProposalNetwork, make_plan_distribution, make_plan_recognition
    from hulc_tpu.models.vision import make_vision_encoder
    from hulc_tpu_torch.models.hulc import masked_clip_loss

    cfg, model, rng = setup["cfg"], setup["model"], np.random.default_rng(92)
    pe = model.perceptual_encoder
    prep = jax_preprocess_batch(setup["jax_cfgs"]["bfloat16"], setup["raw"], rng=None, train=False)["vis"]

    def frames(cam):
        x = getattr(prep, cam)
        return np.asarray(x.reshape((-1,) + x.shape[2:]).astype(jnp.float32))  # bf16 values

    def dist(c):
        return make_plan_distribution(c.distribution)

    emb = rng.normal(size=(B, S, cfg.visual_goal.in_features)).astype(np.float32)
    goal = rng.normal(size=(B, cfg.visual_goal.latent_goal_features)).astype(np.float32)
    plan = rng.normal(size=(B, cfg.distribution.plan_dim)).astype(np.float32)
    seq_feat = rng.normal(size=(B, cfg.plan_recognition.fc_hidden_size)).astype(np.float32)
    mask, scale = np.array([True, False, True]), 14.28

    def one(f):
        return lambda m, p, *x: (f(m.apply({"params": p}, *x)),)

    nchw = lambda m, x: (m(x.permute(0, 3, 1, 2).contiguous()),)
    return {
        cam: (lambda c, dt, cam=cam: make_vision_encoder(getattr(c.perceptual_encoder, cam), dt, cam),
              ("perceptual_encoder", cam), getattr(pe, f"{cam}_encoder"), [frames(cam)], one(lambda y: y), nchw)
        for cam in ("rgb_static", "rgb_gripper")
    } | {
        "visual_goal": (lambda c, dt: JaxGoalEncoder(c.visual_goal, dtype=dt), ("visual_goal",), model.visual_goal,
                        [emb[:, -1]], one(lambda y: y), lambda m, x: (m(x),)),
        "language_goal": (lambda c, dt: make_language_goal_encoder(c.language_goal, dt, "language_goal"),
                          ("language_goal",), model.language_goal,
                          [rng.normal(size=(B, cfg.lang_dim)).astype(np.float32)], one(lambda y: y),
                          lambda m, x: (m(x),)),
        "plan_proposal": (lambda c, dt: PlanProposalNetwork(c.plan_proposal, dist(c), dt), ("plan_proposal",),
                          model.plan_proposal, [emb[:, 0], goal], one(lambda st: st[0]),
                          lambda m, a, g: (m(a, g)[0],)),
        "plan_recognition": (lambda c, dt: make_plan_recognition(c.plan_recognition, dist(c), dt, "plan_recognition"),
                             ("plan_recognition",), model.plan_recognition, [emb],
                             lambda m, p, e: (lambda r: (r[0][0], r[1]))(m.apply({"params": p}, e)),
                             lambda m, e: (lambda r: (r[0][0], r[1]))(m(e))),
        "action_decoder": (lambda c, dt: make_action_decoder(c.action_decoder, dt, "action_decoder"),
                           ("action_decoder",), model.action_decoder, [plan, emb, goal],
                           lambda m, p, *x: tuple(m.apply({"params": p}, *x)[:4]), lambda m, *x: tuple(m(*x)[:4])),
        "clip_loss": (lambda c, dt: JaxProjVisLang(c.proj_vis_lang_dim, dtype=dt), ("proj_vis_lang",),
                      model.proj_vis_lang, [seq_feat, goal],
                      lambda m, p, *x: (jax_clip_loss(*m.apply({"params": p}, *x), jnp.float32(scale), mask),),
                      lambda m, *x: (masked_clip_loss(*m(*x), torch.tensor(scale), torch.from_numpy(mask)),)),
    }


MODULES = ("rgb_static", "rgb_gripper", "visual_goal", "language_goal", "plan_proposal", "plan_recognition",
           "action_decoder", "clip_loss")


@pytest.mark.parametrize("name", MODULES)
def test_hulc_modules_round_where_jax_rounds(hulc_setup, name):
    """Each module of the bf16 path on the same inputs and weights as its
    JAX counterpart: every output within min(1e-2, 0.5 d_ref) of JAX's bf16
    output, the inputs' gradient (a random cotangent on every output)
    within 1.5 d_ref (module docstring)."""
    setup = hulc_setup
    jax_module_of, path, module, inputs, jax_fwd, port_fwd = _modules(setup)[name]
    params = setup["params"]
    for key in path:
        params = params[key]
    cots, want = None, {}
    for dt in ("bfloat16", "float32"):
        jax_module = jax_module_of(setup["jax_cfgs"][dt], getattr(jnp, dt))
        outs = jax.device_get(jax.jit(lambda p, *x: jax_fwd(jax_module, p, *x))(params, *inputs))
        if cots is None:
            rng = np.random.default_rng(93)
            cots = [rng.normal(size=np.shape(o)).astype(np.float32) for o in outs]

        def loss(*x, jax_module=jax_module):
            return sum(jnp.sum(o.astype(jnp.float32) * c) for o, c in zip(jax_fwd(jax_module, params, *x), cots))

        want[dt] = outs, jax.device_get(jax.jit(jax.grad(loss, argnums=tuple(range(len(inputs)))))(*inputs))
    xs = [torch.from_numpy(np.array(x)).requires_grad_() for x in inputs]
    module.eval()
    outs = port_fwd(module, *xs)
    sum((o.float() * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    rows = [check_parity(f"{name} output {i}", o, want["bfloat16"][0][i], want["float32"][0][i])
            for i, o in enumerate(outs)]
    rows += [check_parity(f"{name} input {i} gradient", x.grad, want["bfloat16"][1][i], want["float32"][1][i],
                          CHAOS_SHARE, cap=None) for i, x in enumerate(xs)]
    check_bf16(name, rows)
