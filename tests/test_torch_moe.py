"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's, on the same numpy inputs and the same weights (the reference's
``init_params`` through ``repro_torch.convert``), in f32 on the CPU: both
dispatch paths, their drops and the aux loss; expert-parallel ranks,
emulated in one process, against the whole layer; and the paged engine on
a decode group whose idle rows make the experts drop assignments."""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import ModelOptions as JaxModelOptions
from repro.models import init_params as jax_init_params
from repro.models.moe import _capacity as jax_capacity
from repro.models.moe import _route as jax_route
from repro.models.moe import moe_apply as jax_moe_apply
from repro.serve import PagedServeEngine as JaxPagedServeEngine
from repro.serve import Request as JaxRequest
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import ModelOptions, lm
from repro_torch.models import moe as tmoe
from repro_torch.serve import PagedServeEngine, Request, paged_model

MOE = ["deepseek-moe-16b", "qwen2-moe-a2.7b"]
# the tolerances of test_torch_models.py (outputs against their largest
# entry) and test_torch_train.py (the aux loss, relative)
LOGITS_TOL, LOSS_RTOL = 1e-4, 1e-5


@functools.cache
def _moe_params(arch):
    """The first MoE layer's parameters in both packages (a (2, 64) group of
    the reduced config: 8 experts, top 2, capacity 20 of 128 assignments)."""
    jcfg = jax_reduced_config(arch)
    jp = jax_init_params(jax.random.key(0), jcfg)
    jlayer = jax.tree.map(lambda a: np.asarray(a[0]), jp["main"][0]["moe"])
    return jcfg, reduced_config(arch), jlayer, params_from_numpy(jlayer, device="cpu")


def _jax_drops(jparams, x, m) -> int:
    """Assignments the reference drops: its router's choices, counted
    choice-major against its capacity."""
    n = x.shape[0] * x.shape[1] // min(m.group_size, x.shape[0] * x.shape[1])
    xg = jnp.asarray(x).reshape(n, -1, x.shape[-1])
    _, idx, _ = jax_route(jparams, xg, m)
    C = jax_capacity(m, xg.shape[1])
    drops = 0
    for group in np.asarray(idx):
        seen = np.zeros(m.num_experts, int)
        for e in group.T.reshape(-1):  # choice-major
            drops += seen[e] >= C
            seen[e] += 1
    return int(drops)


def _port_drops(params, x, m) -> int:
    xg = x.reshape(-1, min(m.group_size, x.shape[0] * x.shape[1]), x.shape[-1])
    _, idx, _ = tmoe._route(params, xg, m)
    _, keep = tmoe._slots(idx, tmoe._capacity(m, xg.shape[1]), m.num_experts)
    return int((~keep).sum())


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_moe_apply_matches_jax(arch, impl):
    """One (2, 64) group: the output, the aux loss and the number of
    dropped assignments, which must be above 0."""
    jcfg, tcfg, jparams, tparams = _moe_params(arch)
    m = tcfg.moe.__class__(**{**tcfg.moe.__dict__, "impl": impl})
    jm = jcfg.moe.__class__(**{**jcfg.moe.__dict__, "impl": impl})
    x = np.random.default_rng(7).standard_normal((2, 64, tcfg.d_model)).astype(np.float32)
    want, jaux = jax_moe_apply(jparams, jnp.asarray(x), jm, jcfg.act)
    got, aux = tmoe.moe_apply(tparams, torch.from_numpy(x), m, tcfg.act)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGITS_TOL * np.abs(want).max())
    assert aux.shape == () and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=LOSS_RTOL)
    drops = _port_drops(tparams, torch.from_numpy(x), m)
    assert drops > 0 and drops == _jax_drops(jparams, x, jm)


@pytest.mark.parametrize("arch", MOE)
def test_einsum_and_sort_dispatch_agree(arch):
    """The two dispatch paths, same drops, in the port alone (as
    tests/test_models.py holds the reference's two paths), with the
    gradients of a loss through each."""
    _, tcfg, _, tparams = _moe_params(arch)
    x = np.random.default_rng(8).standard_normal((4, 32, tcfg.d_model)).astype(np.float32)
    outs = {}
    for impl in ("einsum", "sort"):
        m = tcfg.moe.__class__(**{**tcfg.moe.__dict__, "impl": impl})
        xt = torch.from_numpy(x).requires_grad_()
        out, aux = tmoe.moe_apply(tparams, xt, m, tcfg.act)
        (out.square().mean() + aux).backward()
        outs[impl] = (out.detach(), xt.grad)
    for a, b in zip(outs["einsum"], outs["sort"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


def test_moe_groups_must_split_the_tokens():
    """The reference asserts ``T % g == 0``; the port raises ValueError."""
    _, tcfg, _, tparams = _moe_params("deepseek-moe-16b")
    with pytest.raises(ValueError):
        tmoe.moe_apply(tparams, torch.zeros(2, 50, tcfg.d_model), tcfg.moe, tcfg.act)
    with pytest.raises(ValueError):
        ModelOptions(moe_impl="dense")


def test_route_breaks_ties_toward_the_lower_expert():
    """Equal router probabilities go to the lower expert index first, as
    ``jax.lax.top_k`` gives them."""
    m = reduced_config("deepseek-moe-16b").moe
    router = torch.zeros(4, m.num_experts)
    router[0, 5] = router[0, 2] = 1.0  # experts 2 and 5 tie above the rest
    x = torch.tensor([[[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]]])
    gates, idx, _ = tmoe._route({"router": router}, x, m)
    assert idx[0, 0].tolist() == [2, 5]
    assert idx[0, 1].tolist() == [0, 1]  # all equal: the lowest indices
    assert torch.equal(gates[0, 0, 0], gates[0, 0, 1])


# the one-process emulation of expert-parallel ranks: each rank's partials
# summed in rank order against the whole layer, f32, of its largest entry
EP_TOL = 1e-6


@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_ranks_sum_to_the_whole_layer(n, impl):
    """n ranks emulated in one process, at a capacity factor of 1 (two
    groups of 64 tokens, capacity 16 of 128 assignments): each rank's block of
    the slots keeps exactly the whole layer's kept assignments to its
    experts, at the whole layer's slots; its routed output and aux terms,
    from its block of the experts, are f32 partials whose sum in rank
    order is the whole layer's within 1e-6."""
    _, tcfg, _, tparams = _moe_params("deepseek-moe-16b")
    m = replace(tcfg.moe, impl=impl, capacity_factor=1.0)
    E, El = m.num_experts, m.num_experts // n
    x = np.random.default_rng(9).standard_normal((2, 64, tcfg.d_model)).astype(np.float32)
    xg = torch.from_numpy(x)
    _, idx, _ = tmoe._route(tparams, xg, m)
    C = tmoe._capacity(m, xg.shape[1])
    pos, keep = tmoe._slots(idx, C, E)
    assert (~keep).sum() > 0
    owned = torch.zeros_like(idx)
    for r in range(n):
        slot, local = tmoe._local_slots(idx, pos, keep, C, r * El, El)
        owned += local
        assert torch.equal(local, keep & (idx // El == r))
        assert torch.equal(torch.where(local, slot + r * El * C, -1),
                           torch.where(local, idx * C + pos, -1))
        assert bool((slot[~local] == El * C).all())
    assert torch.equal(owned, keep.long())  # each kept assignment on one rank

    dispatch = tmoe._moe_sort if impl == "sort" else tmoe._moe_einsum
    want, want_aux = dispatch(tparams, xg, m, tcfg.act)
    outs, auxs = [], []
    for r in range(n):
        block = {k: v[r * El:(r + 1) * El] if k in ("w_gate", "w_up", "w_down") else v
                 for k, v in tparams.items()}
        out, aux = dispatch(block, xg, m, tcfg.act, r * El)
        assert out.dtype == aux.dtype == torch.float32
        outs.append(out)
        auxs.append(aux)
    got, aux = functools.reduce(torch.add, outs), functools.reduce(torch.add, auxs)
    assert float((got - want).abs().max()) <= EP_TOL * float(want.abs().max())
    assert abs(float(aux) - float(want_aux)) <= EP_TOL * abs(float(want_aux))


# the paged engine with more slots than requests: the idle rows all read
# scratch position (0, 0) and route alike, so they overflow their experts
# and the capacity count reaches the real rows
DROP_PROMPTS = [[1, 5, 9, 2], [1, 5, 9, 2, 7, 3], [4, 4, 8]]


def test_paged_moe_decode_group_with_drops_matches_jax(monkeypatch):
    arch = "deepseek-moe-16b"
    jp = jax_init_params(jax.random.key(0), jax_reduced_config(arch))
    kw = dict(num_blocks=40, block_size=4, max_active=8, prefill_chunk=3)

    def serve(engine_cls, request_cls, cfg, params, opts, **extra):
        eng = engine_cls(cfg, params, opts=opts, **kw, **extra)
        for i, p in enumerate(DROP_PROMPTS):
            eng.submit(request_cls(rid=i, prompt=list(p), max_new_tokens=6))
        done = eng.run_until_drained(max_ticks=400)
        return {r.rid: r.generated for r in done}, eng.metrics()

    want, jm = serve(JaxPagedServeEngine, JaxRequest, jax_reduced_config(arch), jp,
                     JaxModelOptions(compute_dtype="float32"), attn_impl="kernel",
                     interpret=True)
    cfg = reduced_config(arch)
    drops = {"idle": 0, "advancing": 0}
    seen = {}
    real_step, real_moe = paged_model._paged_decode_step, lm.moe_apply

    def step(params, cfg, state, tables, tokens, adv, *rest):
        seen["adv"] = adv
        return real_step(params, cfg, state, tables, tokens, adv, *rest)

    def counted(params, x, m, act):
        xg = x.reshape(1, -1, x.shape[-1])
        _, idx, _ = tmoe._route(params, xg, m)
        _, keep = tmoe._slots(idx, tmoe._capacity(m, xg.shape[1]), m.num_experts)
        lost = (~keep[0]).sum(dim=-1)
        drops["advancing"] += int(lost[seen["adv"]].sum())
        drops["idle"] += int(lost[~seen["adv"]].sum())
        return real_moe(params, x, m, act)

    monkeypatch.setattr(paged_model, "_paged_decode_step", step)
    monkeypatch.setattr(lm, "moe_apply", counted)
    got, tm = serve(PagedServeEngine, Request, cfg, params_from_numpy(jp, device="cpu"),
                    ModelOptions(compute_dtype="float32"), device="cpu")
    assert got == want and len(got) == len(DROP_PROMPTS)
    assert tm == jm
    assert drops["idle"] > 0 and drops["advancing"] > 0, drops
