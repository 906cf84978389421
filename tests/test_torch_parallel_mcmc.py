"""PyTorch port, the chain-sharded samplers (``parallel/mcmc.py``) on 1, 2
and 4 gloo ranks: random-walk MH, parallel tempering, ChEES-HMC and the
stretch move over a ``parallel.Mesh({"chains": P})``.

Each group size starts its ranks once (tests/_torch_parallel_worker.py)
and runs every case. On one rank each sampler is bitwise the unsharded
sampler seeded with ``rank_seed(seed, 0)``. On 2 and 4 ranks each rank
replays its own draws (numpy normals and uniforms of its block's shapes),
and every rank must hold one step-size trajectory (PT: one ladder too;
ChEES: one trajectory length and mass diagonal), equal to the unsharded
sampler run in this process on all C chains with the ranks' draws joined
along the chain axis: the pooled acceptance of 0/1 decisions over blocks
of a power-of-two size is exact, so MH and PT (fixed ladder) are bitwise
(but MH's final rate, a float mean of each chain's count, at rtol 1e-5);
PT's adapted ladder and ChEES pool float means, at rtol 1e-5. The stretch
move runs an independent ensemble on each rank: each rank's walkers are
bitwise the unsharded move on its block, and the accept rate is the
ranks' mean. The 3-D ``init_x`` refusal of the sharded PT sampler holds
on every mesh size.
"""

import _torch_threads  # noqa: F401
import types

import numpy as np
import pytest
import torch

from _torch_parallel_worker import finish_group, start_group

from cusmc_tpu_torch.mcmc import chees_hmc_sampler, \
    metropolis_hastings_sampler, parallel_tempering_sampler, \
    stretch_move_sampler
from cusmc_tpu_torch.parallel import sharded_pt_sampler
from cusmc_tpu_torch.parallel.mesh import rank_seed

C, D, R = 32, 3, 4
STDS = np.asarray([1.0, 2.0, 0.5], np.float32)
INIT = np.random.default_rng(0).standard_normal((C, D)).astype(np.float32)
KW = {"mh": dict(step_size=0.8, num_adapt=20),
      "pt": dict(num_rungs=R, beta_min=0.1, step_size=0.6, num_adapt=20),
      "pt-ladder": dict(num_rungs=R, beta_min=0.1, step_size=0.6,
                        adapt_ladder=True, num_adapt=20),
      "chees": dict(step_size=0.3, init_traj=0.6, num_adapt=12),
      "stretch": {}}
STEPS = {"mh": 30, "pt": 30, "pt-ladder": 30, "chees": 16, "stretch": 30}
UNSHARDED = {"mh": metropolis_hastings_sampler,
             "pt": parallel_tempering_sampler,
             "pt-ladder": parallel_tempering_sampler,
             "chees": chees_hmc_sampler, "stretch": stretch_move_sampler}


def _sampler(case):
    return case.split("-")[0]


def rank_draws(case, P, seed=0):
    """Each rank's replayed draws for its block of C / P chains."""
    rng = np.random.default_rng(seed)
    L, steps = C // P, STEPS[case]
    f32 = np.float32

    def u(*shape):
        return rng.random(shape).astype(f32)

    def z(*shape):
        return rng.standard_normal(shape).astype(f32)

    out = []
    for _ in range(P):
        if case == "stretch":
            h = L // 2
            out.append([tuple((u(h), rng.integers(0, h, h), u(h))
                              for _ in range(2)) for _ in range(steps)])
        elif case.startswith("pt"):
            out.append([(z(R, L, D), u(R, L), u(R - 1, L))
                        for _ in range(steps)])
        else:
            out.append([(z(L, D), u(L)) for _ in range(steps)])
    return out


def joined(draws, case):
    """The ranks' draws joined along the chain axis, one a sweep."""
    axis = 1 if case.startswith("pt") else 0
    return [tuple(torch.from_numpy(np.concatenate(parts, axis=axis))
                  for parts in zip(*sweep)) for sweep in zip(*draws)]


def _case(cid, case, P, draws=None, **kw):
    return dict(id=cid, kind="mcmc", sampler=_sampler(case), P=P,
                init=INIT, stds=STDS, steps=STEPS[case], seed=7,
                kwargs=KW[case], draws=draws, **kw)


CASES = sorted(KW)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mcmc")
    groups = {}
    for P in (1, 2, 4):
        cases = [_case(f"refuse-{P}", "pt", P, refuse=True)]
        for case in CASES:
            if P == 1:
                cases.append(_case(case, case, P, keep=True))
            else:
                cases.append(_case(case, case, P, rank_draws(case, P),
                                   keep=case == "mh"))
        groups[P] = start_group(P, cases, tmp)
    return {P: finish_group(g) for P, g in groups.items()}


def _logp(x):
    return -0.5 * torch.sum((x / torch.from_numpy(STDS)) ** 2, dim=-1)


def _fields(res):
    out = {k: v for k, v in vars(res).items() if k != "state"}
    if hasattr(res, "state"):
        out.update({f"state.{k}": v for k, v in vars(res.state).items()})
    return {k: v.numpy() for k, v in out.items() if v is not None}


@pytest.mark.parametrize("case", CASES)
def test_one_rank_is_the_unsharded_sampler(runs, case):
    got = runs[1][0][case]
    gen = torch.Generator().manual_seed(rank_seed(7, 0))
    want = _fields(UNSHARDED[case](gen, _logp, torch.from_numpy(INIT),
                                   STEPS[case], keep_samples=True,
                                   **KW[case]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _block(a, r, P, case):
    L = C // P
    return a[:, r * L:(r + 1) * L] if case.startswith("pt") else \
        a[r * L:(r + 1) * L]


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_ranks_pool_one_trajectory(runs, case, P):
    ranks = [r[case] for r in runs[P]]
    draws = rank_draws(case, P)
    pooled = ("step_size", "accept_rate", "betas", "swap_rate",
              "traj_length", "mass_var", "mean_leapfrog")
    for k in pooled:  # every rank holds the same adapted values
        if k in ranks[0]:
            for other in ranks[1:]:
                np.testing.assert_array_equal(other[k], ranks[0][k],
                                              err_msg=k)
    init = torch.from_numpy(INIT)
    if case == "stretch":
        L = C // P
        rates = []
        for r, got in enumerate(ranks):
            draws_r = [tuple(tuple(torch.from_numpy(np.asarray(v))
                                   for v in half) for half in sweep)
                       for sweep in draws[r]]
            want = stretch_move_sampler(None, _logp, init[r * L:(r + 1) * L],
                                        STEPS[case], draws=draws_r)
            np.testing.assert_array_equal(got["x"], want.x.numpy())
            rates.append(float(want.accept_rate))
        np.testing.assert_allclose(ranks[0]["accept_rate"], np.mean(rates),
                                   rtol=1e-6)
        return
    want = _fields(UNSHARDED[case](None, _logp, init, STEPS[case],
                                   keep_samples=case == "mh",
                                   draws=joined(draws, case), **KW[case]))
    exact = case in ("mh", "pt")
    for k, v in want.items():
        for r, got in enumerate(ranks):
            ours = got[k]
            if k in ("state.x", "state.logp", "state.grad", "samples"):
                v_r = (v[:, r * (C // P):(r + 1) * (C // P)]
                       if k == "samples" else _block(v, r, P, case))
            elif k == "state.accept_count" and case in ("mh", "chees"):
                v_r = _block(v, r, P, case)
            else:
                v_r = v
            if exact and k != "accept_rate":
                np.testing.assert_array_equal(ours, v_r, err_msg=k)
            else:
                np.testing.assert_allclose(ours, v_r, rtol=1e-5, atol=1e-5,
                                           err_msg=k)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_sharded_pt_refuses_a_3d_init_on_every_mesh(runs, P):
    assert all("[C, d]" in r[f"refuse-{P}"] for r in runs[P])
    mesh = types.SimpleNamespace(shape={"chains": P}, axes={})
    with pytest.raises(ValueError, match="C, d"):
        sharded_pt_sampler(0, _logp, torch.zeros((R, C, D)), 5, mesh)


def test_sharded_samplers_check_their_inputs():
    from cusmc_tpu_torch.parallel import sharded_mh_sampler, \
        sharded_stretch_sampler

    mesh = types.SimpleNamespace(shape={"chains": 4}, axes={})
    with pytest.raises(ValueError, match="not divisible"):
        sharded_mh_sampler(0, _logp, torch.zeros((30, D)), 5, mesh)
    with pytest.raises(ValueError, match="2d\\+2"):
        sharded_stretch_sampler(0, _logp, torch.zeros((16, D)), 5, mesh)
    with pytest.raises(TypeError, match="int seed"):
        sharded_mh_sampler(torch.Generator(), _logp, torch.zeros((32, D)),
                           5, types.SimpleNamespace(shape={"chains": 1}))
