"""The global gradient norm (B.7) and the Adam kernel's table and block plan
(B.5), on the CPU: the plain ``global_norm`` against ``optax.global_norm``,
the norm ``AdamLowp.step`` returns, the plain mirror of the kernel's
two-level fixed-order sum against an fp64 sum, the block ranges and the
pointer-table cache. The kernels themselves run only on the card
(``chip_smoke.py``)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hulc_tpu.training.optimizers import scale_by_adam_lowp
from hulc_tpu_torch import kernels
from hulc_tpu_torch.training import optimizers
from hulc_tpu_torch.training.optimizers import (
    ELEMS_PER_BLOCK,
    AdamLowp,
    PointerTable,
    adam_lowp_update,
    block_ranges,
    blocks_of,
    fixed_order_sum,
    global_norm,
    grad_norm_finish_plain,
    grad_norm_partials_plain,
    pointer_table_rows,
    vector_head,
)

torch.set_num_threads(1)

# odd sizes, a size-1 leaf, one that spans several blocks with a tail
SHAPES = {"a": (33, 7), "b": (5,), "c": (1,), "d": (2, 3, 4), "e": (ELEMS_PER_BLOCK * 2 + 3,), "f": (3,)}


def _tree(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * 10.0 ** rng.uniform(-4, 1, s)).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_norm_matches_optax(seed):
    tree = _tree(seed)
    want = float(optax.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = global_norm([torch.from_numpy(v) for v in tree.values()])
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_global_norm_counts_none_as_zeros():
    tree = _tree(3)
    ts = [torch.from_numpy(v) for v in tree.values()]
    assert torch.equal(global_norm([None, *ts, None]), global_norm(ts))
    assert float(global_norm([None])) == 0.0


def test_adam_lowp_step_returns_the_plain_norm_of_what_it_applied():
    """Three steps; one parameter never has a gradient (a zero gradient, as
    optax sees it). Each step's returned norm is optax.global_norm of the
    tree of gradients (zeros for the missing one), the updates match optax's
    (moments bit-equal, params 1e-7) and the parameter without a gradient
    moves as optax moves a leaf whose gradient is zero."""
    params = _tree(10, {k: SHAPES[k] for k in "abcd"})
    lr = 3e-3
    tx = optax.chain(scale_by_adam_lowp(), optax.scale_by_learning_rate(optax.constant_schedule(lr)))
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = AdamLowp(t_params.values(), lr=lambda count: lr)
    for step in range(3):
        grads = _tree(20 + step, {k: SHAPES[k] for k in "abcd"})
        grads["c"] = np.zeros_like(grads["c"])
        j_grads = jax.tree.map(jnp.asarray, grads)
        updates, j_state = tx.update(j_grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in t_params.items():
            p.grad = None if k == "c" else torch.from_numpy(grads[k])
        norm = opt.step()
        assert norm.dtype == torch.float32 and norm.dim() == 0
        np.testing.assert_allclose(float(norm), float(optax.global_norm(j_grads)), rtol=1e-6)
        assert torch.equal(norm, global_norm([p.grad for p in t_params.values()]))
    for k, p in t_params.items():
        st = opt.state[p]
        np.testing.assert_array_equal(st["exp_avg"].float().numpy(), np.asarray(j_state[0].mu[k], np.float32))
        np.testing.assert_array_equal(st["exp_avg_sq"].float().numpy(), np.asarray(j_state[0].nu[k], np.float32))
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]), atol=1e-7, rtol=0)


@pytest.mark.parametrize("numel", [1, 3, 4, 5, 8, ELEMS_PER_BLOCK - 1, ELEMS_PER_BLOCK, ELEMS_PER_BLOCK + 3,
                                   ELEMS_PER_BLOCK + 4, 3 * ELEMS_PER_BLOCK + 6])
def test_block_ranges_cover_each_element_once(numel):
    """Every head 0-3: the blocks tile [0, numel) in order, block 0 holds
    the head, every later block starts on a 4-element group after it, only
    the last block is short of ELEMS_PER_BLOCK elements of groups."""
    for head in range(min(4, numel + 1)):
        ranges = block_ranges(numel, head)
        assert len(ranges) == blocks_of(numel, head)
        assert ranges[0][0] == 0 and ranges[-1][1] == numel
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all((begin - head) % 4 == 0 for begin, _ in ranges[1:])
        groups = (numel - head) // 4
        for j, (begin, end) in enumerate(ranges[:-1]):
            assert end - max(begin, head) == ELEMS_PER_BLOCK, (j, head)
        assert 4 * groups + head - max(ranges[-1][0], head) <= ELEMS_PER_BLOCK


def test_vector_head_aligns_the_groups():
    # p 4 bytes past a 16-byte boundary (its g, m, v at the same phase): 3 scalar elements first
    assert vector_head(4100, 100) == 3
    assert vector_head(4096, 100) == 0
    assert vector_head(4104, 100) == 2
    assert vector_head(4100, 2) == 2  # the head is the whole tensor


def _sizes_and_views():
    """CPU tensors as the wrapper would get them: sizes that are not a
    multiple of 4 and one tensor whose four arrays are views one element
    past their storages' start."""
    gen = torch.Generator().manual_seed(5)
    sizes = (1, 3, 4, 5, ELEMS_PER_BLOCK + 1, 2 * ELEMS_PER_BLOCK + 7)
    ps = [torch.randn(n, generator=gen) for n in sizes]
    gs = [torch.randn(p.shape, generator=gen) for p in ps]
    ms = [torch.zeros(p.shape, dtype=torch.bfloat16) for p in ps]
    vs = [torch.zeros(p.shape, dtype=torch.bfloat16) for p in ps]
    for arrays in (ps, gs, ms, vs):
        arrays.append(torch.randn(101, generator=gen).to(arrays[0].dtype)[1:])
    return ps, gs, ms, vs


def test_fixed_order_sum_matches_fp64():
    """The kernel's two levels, mirrored: per-block sums of g^2 over the
    plan's ranges (an empty tensor among them), then the finish launch's
    order; within 1e-12 of one fp64 sum, and the fp32 norm within one
    rounding of sqrt of it."""
    ps, gs, ms, vs = _sizes_and_views()
    gs[1] = gs[1] * 1e4
    gs[4] = gs[4] * 1e-4
    for arrays, dtype in ((ps, torch.float32), (gs, torch.float32), (ms, torch.bfloat16), (vs, torch.bfloat16)):
        arrays.insert(2, torch.zeros(0, dtype=dtype))  # a tensor without elements has no row and no block
    _, n_blocks = pointer_table_rows(ps, ms, vs)
    partials = grad_norm_partials_plain(ps, gs)
    assert partials.shape == (n_blocks,) and partials.dtype == torch.float64
    want = sum(float((g.double() ** 2).sum()) for g in gs)
    np.testing.assert_allclose(float(fixed_order_sum(partials)), want, rtol=1e-12)
    np.testing.assert_allclose(float(grad_norm_finish_plain(partials)), np.float32(np.sqrt(want)), rtol=2**-24)
    # many partials: every thread of the finish takes a share
    many = torch.rand(optimizers.FINISH_THREADS * 3 + 17, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(float(fixed_order_sum(many)), float(many.sum()), rtol=1e-12)
    assert float(grad_norm_finish_plain(torch.zeros(0, dtype=torch.float64))) == 0.0


def test_pointer_table_cache_rebuilds_only_when_a_tensor_changes():
    """Reused while the parameters' and moments' addresses and the sizes
    stay (the gradients' addresses, new each step, go to each launch by
    value); rebuilt for a new p, m or v address or a new size."""
    ps, gs, ms, vs = _sizes_and_views()
    table = PointerTable()
    first = table.get(ps, ms, vs)
    assert table.get(ps, ms, vs) is first and table.builds == 1
    rows, n_blocks = pointer_table_rows(ps, ms, vs)
    blocks = [i for i, row in enumerate(rows) for _ in range(blocks_of(row[3], row[4]))]
    assert first.tolist() == [x for row in rows for x in row] + blocks
    assert (table.n_tensors, table.n_blocks) == (len(ps), n_blocks) == (len(ps), len(blocks))
    assert table.first_blocks == [row[5] for row in rows] + [n_blocks]
    ms[2] = ms[2].clone()  # a new moment
    assert table.get(ps, ms, vs) is not first and table.builds == 2
    assert table.get(ps, ms, vs) is table.table and table.builds == 2
    ps[0] = ps[0].clone()  # a new parameter
    table.get(ps, ms, vs)
    assert table.builds == 3
    ps[3] = torch.zeros(6)  # a new size
    ms[3], vs[3] = torch.zeros(6, dtype=torch.bfloat16), torch.zeros(6, dtype=torch.bfloat16)
    table.get(ps, ms, vs)
    assert table.builds == 4 and table.table[6 * 3 + 3].item() == 6


def test_adam_lowp_update_refuses_cpu_tensors():
    """The kernel wrappers never run the plain version: a CPU tensor raises."""
    ps, gs, ms, vs = _sizes_and_views()
    with pytest.raises(ValueError, match="CUDA"):
        adam_lowp_update(ps, gs, ms, vs, 0.9, 0.999, 1e-8, -1e-3, 0.1, 0.001)
    with pytest.raises(ValueError, match="CUDA"):
        optimizers.grad_norm_finish(torch.zeros(3, dtype=torch.float64))


def test_adam_lowp_constants_match_the_cuda_source():
    """The table's row width, the gradients a launch takes, the finish
    launch's thread count and the entry points' argument counts are
    csrc/adam_lowp.cu's."""
    src = (kernels.CSRC_DIR / "adam_lowp.cu").read_text()

    def const(name):
        return int(re.search(rf"const int {name} = (\d+);", src).group(1))

    ps, gs, ms, vs = _sizes_and_views()
    rows, _ = pointer_table_rows(ps, ms, vs)
    assert const("kRowCols") == len(rows[0]) == 6
    assert const("kFinishThreads") == optimizers.FINISH_THREADS
    assert const("kMaxGrads") == optimizers.MAX_GRADS_PER_LAUNCH
    assert ELEMS_PER_BLOCK % 4 == 0
    assert len(kernels._SIGNATURES["hulc_adam_lowp"]) == 17
    assert len(kernels._SIGNATURES["hulc_grad_norm_finish"]) == 3
    assert kernels.GRAD_NORM_FINISH in kernels.ALL_KERNELS


def test_adam_in_step_counts_zeros_in_zero_lines():
    """The zero-gradient probe of ``evaluation/adam_in_step.py``: a zero in
    a zero row or a zero column of the tensor as a (first dim, rest)
    matrix counts as in a zero line; a stray zero does not; each zero of a
    1-d tensor does."""
    from hulc_tpu_torch.evaluation.adam_in_step import gradient_zeros, zero_lines

    w = torch.arange(1.0, 13.0).reshape(3, 2, 2)
    w[1] = 0.0  # a zero row of the (3, 4) matrix
    w[:, 0, 1] = 0.0  # a zero column
    w[2, 1, 1] = 0.0  # a stray zero
    assert zero_lines(w) == 4 + 2
    b = torch.tensor([0.0, 1.0, 0.0])
    assert zero_lines(b) == 2
    tiny = torch.tensor([1e-30, 1.0])  # squares to below fp32's smallest normal
    got = gradient_zeros([("w", w), ("b", b), ("tiny", tiny)])
    assert got["tensors"] == {"w": [12, 7, 6], "b": [3, 2, 2]}
    assert got["zero_share"] == 9 / 17 and got["zeros_in_zero_lines_share"] == 8 / 9
    assert got["square_subnormal_share"] == 1 / 17 and got["tensors_with_zeros"] == 2
