"""The plain reference against the program's CPU path at tiny sizes: the
six query kinds and one stochastic EM step, on RAT and PD structures."""

import dataclasses

import numpy as np
import pytest
import torch

from reference.einet import Reference, leaves_of
from reference.structure import layout_of

from repro_torch.configs import EinetConfig
from repro_torch.core.em import EMConfig, params_of
from repro_torch.launch.cells import build_einet
from repro_torch.train import TrainConfig, make_em_step

TINY = {
    "rat": {"structure": "rat", "num_vars": 16, "depth": 2,
            "num_repetitions": 3, "num_sums": 4, "num_classes": 1,
            "min_var": 1e-6, "max_var": 10.0},
    "pd": {"structure": "pd", "height": 4, "width": 6, "num_channels": 2,
           "delta": 2, "pd_axes": ["w"], "num_sums": 3, "num_classes": 1,
           "min_var": 1e-6, "max_var": 10.0},
    "pd_pixels": {"structure": "pd", "height": 4, "width": 6,
                  "num_channels": 2, "delta": 2, "pd_axes": ["w"],
                  "num_sums": 3, "num_classes": 1, "min_var": 1e-6,
                  "max_var": 0.01, "data": "unit_uniform"},
    "pd_hw": {"structure": "pd", "height": 4, "width": 4, "num_channels": 1,
              "delta": 2, "pd_axes": ["h", "w"], "num_sums": 3,
              "num_classes": 1, "min_var": 1e-6, "max_var": 10.0},
}
EM = {"laplace_alpha": 1e-4, "stat_floor": 1e-12, "step_size": 0.5}


def program(cfg):
    fields = {f.name for f in dataclasses.fields(EinetConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in cfg.items() if k in fields}
    return build_einet(EinetConfig(name="tiny", **kw), device="cpu", seed=3)


def both(name):
    cfg = TINY[name]
    model = program(cfg)
    ref = Reference(cfg, "cpu")
    params = {k: (v.clone() if torch.is_tensor(v) else [t.clone() for t in v])
              for k, v in params_of(model).items()}
    shapes = ref.lay.shapes()
    assert tuple(params["phi"].shape) == shapes["phi"]
    assert [tuple(w.shape) for w in params["einsum"]] == shapes["einsum"]
    assert [tuple(v.shape) for v in params["mixing"]] == shapes["mixing"]
    return cfg, model, ref, params


def batch(d, b, seed, data="standard_normal"):
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(b, d, generator=g) if data == "unit_uniform"
         else torch.randn(b, d, generator=g))
    ev = torch.rand(b, d, generator=g) < 0.5
    seeds = torch.randint(0, 2 ** 40, (b,), generator=g)
    return {"x": x, "evidence_mask": ev, "query_mask": ~ev, "seeds": seeds}


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("kind", ["joint_ll", "marginal_ll", "conditional_ll",
                                  "sample", "conditional_sample", "mpe"])
def test_queries_agree(name, kind):
    cfg, model, ref, params = both(name)
    bt = batch(model.num_vars, 9, 1, cfg.get("data", "standard_normal"))
    got = model.query(bt, kind)
    want = ref.query(params, kind, bt["x"], bt["evidence_mask"],
                     bt["query_mask"], bt["seeds"], block=4)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", sorted(TINY))
def test_em_step_agrees(name):
    cfg, model, ref, params = both(name)
    x = batch(model.num_vars, 12, 2, cfg.get("data", "standard_normal"))["x"]
    step = make_em_step(model, TrainConfig(em=EMConfig(**EM), health=False))
    ll = step(x)
    new, want_ll = ref.em_step(params, x, EM, block=5)
    assert abs(ll - want_ll) <= 1e-5 * abs(want_ll)
    for got, want in zip(leaves_of(params_of(model)), leaves_of(new)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_layout_matches_the_program_buffer():
    for name in TINY:
        model = program(TINY[name])
        lay = layout_of(TINY[name])
        assert lay.noise_size == model.noise_size
        assert lay.root_row == model.root_row
        assert np.array_equal(lay.pair_var, model.leaf_pair_var.numpy())
        for p, sp in zip(lay.pairs, model.pair_specs):
            assert np.array_equal(p.left, sp.left)
            assert np.array_equal(p.right, sp.right)


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("kind", ["sample", "conditional_sample", "mpe"])
def test_draw_margins(name, kind):
    """Asked for margins, a drawing kind gives the same rows and each
    row's narrowest margin; where every component, weight and mixture
    weight is alike, every greedy choice ties."""
    cfg, model, ref, params = both(name)
    bt = batch(model.num_vars, 9, 4, cfg.get("data", "standard_normal"))
    args = (bt["x"], bt["evidence_mask"], bt["query_mask"], bt["seeds"])
    plain = ref.query(params, kind, *args, block=4)
    rows, margin = ref.query(params, kind, *args, block=4, margin=True)
    torch.testing.assert_close(rows, plain, rtol=0, atol=0)
    assert margin.shape == (9,) and bool((margin >= 0).all())
    assert bool(torch.isfinite(margin).all())
    alike = dict(params, phi=params["phi"][:, :1].expand_as(params["phi"]).clone(),
                 einsum=[torch.ones_like(w) for w in params["einsum"]],
                 mixing=[torch.ones_like(v) for v in params["mixing"]])
    _, margin = ref.query(alike, kind, *args, block=4, margin=True)
    if kind == "mpe":
        assert bool((margin == 0).all())
    else:
        assert bool((margin > 0).all())
