"""The port's image-evaluation workbench (``repro_torch.eval``), the eval
CLI and the part of ``repro_torch.obs`` they read, on the CPU against the
JAX reference (``repro.eval``, ``repro.obs``), with the same parameters
carried across as numpy.

Tolerances: masks, the bits-per-dim formula, MPE reconstructions and PNG
pixels exactly; log-likelihoods rtol 1e-5, atol 1e-4 (as
``test_torch_einet.py``); the mean-fill baseline and missing fractions rtol
1e-6; the workbench record's mean LLs and MSEs rtol 1e-5.  The port's own
engine-vs-direct parity is bitwise, as the reference's.  Conditional
samples come from Philox in the port and threefry in the reference, so
they are held only to their evidence.  Sizes: the reference's ``pd_net``
(8x8x1, Delta=4, K=4, normal leaves, variance clamp [1e-6, 1e-2]) and a
C=2 mixture of it; images from ``synthetic_image_dataset(8, 8, 1, 64, 24,
seed=0)``.  Every reference engine here uses ``max_batch=4``, so its
compiled programs (cached per model) are shared between tests.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.configs import EinetConfig as RefEinetConfig
from repro.data import datasets as ref_ds
from repro.eval import grids as ref_grids
from repro.eval import inpainting as ref_inp
from repro.eval import masks as ref_masks
from repro.eval import metrics as ref_metrics
from repro.eval import workbench as ref_wb
from repro.launch.cells import build_einet as ref_build_einet
from repro.mixture import EiNetMixture as RefEiNetMixture
from repro_torch import obs
from repro_torch.configs import EinetConfig
from repro_torch.convert import mixture_params_from_jax, params_from_jax
from repro_torch.eval import grids, inpainting, masks, metrics, workbench
from repro_torch.launch.cells import build_einet
from repro_torch.mixture import EiNetMixture, MixtureTrainConfig, fit_mixture
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import fit

ROOT = Path(__file__).resolve().parents[1]
LL_TOL = dict(rtol=1e-5, atol=1e-4)
H = W = 8
C = 1
D = H * W * C
REF_MAX_BATCH = 4

_CFG = dict(name="einet-pd-test", structure="pd", height=H, width=W,
            num_channels=C, delta=4, pd_axes=("w",), num_sums=4,
            exponential_family="normal", min_var=1e-6, max_var=1e-2)


def _port_einet():
    return build_einet(EinetConfig(**_CFG), device="cpu")


@pytest.fixture(scope="module")
def pd_pair():
    ref = ref_build_einet(RefEinetConfig(**_CFG))
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))
    pnp = jax.tree_util.tree_map(np.asarray, params)
    port = _port_einet()
    port.load_state_dict(params_from_jax(pnp, port))
    return ref, params, port


@pytest.fixture(scope="module")
def mix_pair():
    ref = RefEiNetMixture(ref_build_einet(RefEinetConfig(**_CFG)), 2)
    params = jax.jit(ref.init)(jax.random.PRNGKey(3))
    pnp = jax.tree_util.tree_map(np.asarray, params)
    port = EiNetMixture(_port_einet(), 2)
    port.load_state_dict(mixture_params_from_jax(pnp, port))
    return ref, params, port


@pytest.fixture(params=["single", "mixture"])
def model_pair(request, pd_pair, mix_pair):
    return (pd_pair if request.param == "single" else mix_pair), \
        ("" if request.param == "single" else "mixture_")


@pytest.fixture(scope="module")
def data():
    d = ref_ds.synthetic_image_dataset(H, W, C, num_train=64, num_test=24,
                                       seed=0)
    train, _ = ref_ds.to_domain(d.train_x, "normal")
    test, _ = ref_ds.to_domain(d.test_x, "normal")
    return train, test


# ----------------------------------------------------------------- masks
@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("kind", masks.MASK_KINDS)
def test_make_mask_equals_reference(kind, seed):
    assert masks.MASK_KINDS == ref_masks.MASK_KINDS
    for h, w, c in ((H, W, C), (5, 7, 3), (32, 32, 3)):
        got = masks.make_mask(kind, h, w, c, seed=seed)
        want = ref_masks.make_mask(kind, h, w, c, seed=seed)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(KeyError):
        masks.make_mask("diagonal", H, W, C)


# --------------------------------------------------------------- metrics
@pytest.mark.parametrize("mean_ll,dims,offset", [
    (0.0, 64, 8.0), (-64.0, 64, 0.0), (-1234.5678, 3072, 8.0),
    (5230.82, 3072, 8.0), (-17.25, 7, 0.0)])
def test_bits_per_dim_equals_reference(mean_ll, dims, offset):
    assert metrics.bits_per_dim(mean_ll, dims, offset) == \
        ref_metrics.bits_per_dim(mean_ll, dims, offset)


@pytest.mark.parametrize("kind", ["joint_ll", "marginal_ll"])
def test_engine_lls_match_reference(model_pair, data, kind):
    (ref, params, port), prefix = model_pair
    x = data[1][:12]
    ev = masks.make_mask("left_half", H, W, C) if kind == "marginal_ll" \
        else None
    got = metrics.engine_log_likelihoods(
        port, x, kind=prefix + kind, evidence_mask=ev,
        max_batch=REF_MAX_BATCH, parity_rows=None)
    want = ref_metrics.engine_log_likelihoods(
        ref, params, x, kind=prefix + kind, evidence_mask=ev,
        max_batch=REF_MAX_BATCH, parity_rows=0)
    np.testing.assert_allclose(got.ll, want.ll, **LL_TOL)
    assert got.parity_rows == len(x) and got.parity_mismatches == 0
    assert got.parity_max_abs_diff == 0.0 and got.warmup_seconds >= 0
    dense = metrics.direct_log_likelihoods(port, x, kind=prefix + kind,
                                           evidence_mask=ev, chunk=5)
    np.testing.assert_allclose(dense, want.ll, **LL_TOL)
    with pytest.raises(ValueError):
        metrics.engine_log_likelihoods(port, x, kind=prefix + "mpe")


def test_evaluate_bpd_record(pd_pair, data):
    _, _, port = pd_pair
    rec = metrics.evaluate_bpd(port, data[1][:8], offset_bits=8.0,
                               max_batch=4, parity_rows=None)
    assert rec["parity_mismatches"] == 0 and rec["parity_rows"] == 8
    assert rec["bpd"] == metrics.bits_per_dim(rec["mean_ll"], D, 8.0)
    assert rec["engine_rows_per_s"] > 0


# ------------------------------------------------------------ inpainting
@pytest.fixture(scope="module")
def inpaint_runs(pd_pair, mix_pair, data):
    """Each model's harness on both sides (6 test images, all four masks,
    train-mean fill); the port also at max_batch 1 and 8."""
    train, test = data
    out = {}
    for name, (ref, params, port), kinds, ref_kinds in (
            ("single", pd_pair, inpainting.INPAINT_KINDS,
             ref_inp.INPAINT_KINDS),
            ("mixture", mix_pair, inpainting.MIXTURE_INPAINT_KINDS,
             ref_inp.MIXTURE_INPAINT_KINDS)):
        assert kinds == ref_kinds
        args = (test[:6], H, W, C)
        kw = dict(mean_fill=train.mean(axis=0), seed=2, kinds=kinds)
        out[name] = {
            "ref": ref_inp.run_inpainting(ref, params, *args,
                                          max_batch=REF_MAX_BATCH,
                                          parity_rows=0, **kw),
            "port": {mb: inpainting.run_inpainting(port, *args,
                                                   max_batch=mb, **kw)
                     for mb in (1, 8)},
        }
    return out, test[:6]


@pytest.mark.parametrize("which", ["single", "mixture"])
def test_inpainting_matches_reference(inpaint_runs, which):
    runs, images = inpaint_runs
    ref = runs[which]["ref"]
    port = runs[which]["port"][8]
    assert port.mask_kinds == ref.mask_kinds == masks.MASK_KINDS
    assert port.metrics["parity_mismatches"] == 0
    assert port.metrics["parity_rows"] == port.metrics["num_requests"] \
        == len(images) * len(masks.MASK_KINDS) * 2
    for mk in masks.MASK_KINDS:
        ev = port.evidence_masks[mk]
        assert np.array_equal(ev, ref.evidence_masks[mk])
        # argmax parity: the decodes are the reference's bit for bit
        assert np.array_equal(port.recon(mk, "mpe"), ref.recon(mk, "mpe"))
        sample = port.recon(mk, "conditional_sample")
        assert np.all(np.isfinite(sample))
        assert np.array_equal(sample[:, ev], images[:, ev])
        got, want = port.metrics["per_mask"][mk], ref.metrics["per_mask"][mk]
        assert set(got) == set(want)
        for key in ("missing_fraction", "mean_fill_mse"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
        np.testing.assert_allclose(got["mpe_mse"], want["mpe_mse"], rtol=1e-5)
    assert set(port.metrics) == set(ref.metrics)


@pytest.mark.parametrize("which", ["single", "mixture"])
def test_inpainting_is_independent_of_the_micro_batch(inpaint_runs, which):
    runs, _ = inpaint_runs
    one, eight = runs[which]["port"][1], runs[which]["port"][8]
    assert one.metrics["parity_mismatches"] == 0
    for mk in masks.MASK_KINDS:
        for qk in ("conditional_sample", "mpe"):
            assert np.array_equal(one.recon(mk, qk), eight.recon(mk, qk))


# ----------------------------------------------------------------- grids
@pytest.mark.parametrize("channels", [1, 3])
def test_png_grids_equal_reference_pixels(tmp_path, channels):
    from PIL import Image

    rng = np.random.RandomState(channels)
    imgs = rng.rand(5, H, W, channels).astype(np.float32) * 1.2 - 0.1
    for cols in (3, 8):
        got = grids.save_image_grid(str(tmp_path / f"p{cols}.png"), imgs,
                                    columns=cols)
        want = ref_grids.save_image_grid(str(tmp_path / f"r{cols}.png"),
                                         imgs, columns=cols)
        with open(got, "rb") as f:
            assert f.read(8) == grids.PNG_SIGNATURE
        a, b = Image.open(got), Image.open(want)
        assert a.mode == b.mode == ("L" if channels == 1 else "RGB")
        assert np.array_equal(np.asarray(a), np.asarray(b))
    flat = imgs.reshape(5, -1)
    ev = masks.make_mask("bottom_half", H, W, channels)
    got = grids.save_inpainting_grid(str(tmp_path / "pi.png"), flat, ev,
                                     flat[::-1], flat * 0.5, H, W, channels,
                                     vmax=1.1)
    want = ref_grids.save_inpainting_grid(str(tmp_path / "ri.png"), flat, ev,
                                          flat[::-1], flat * 0.5, H, W,
                                          channels, vmax=1.1)
    assert np.array_equal(np.asarray(Image.open(got)),
                          np.asarray(Image.open(want)))


def test_metrics_json_bytes_equal_reference(tmp_path):
    rec = {"bpd": np.float32(1.5), "n": 3, "nested": {"b": [1, 2], "a": None},
           "name": "run"}
    got = grids.save_metrics_json(str(tmp_path / "p" / "metrics.json"), rec)
    want = ref_grids.save_metrics_json(str(tmp_path / "r" / "metrics.json"),
                                       rec)
    assert Path(got).read_bytes() == Path(want).read_bytes()
    loaded = grids.load_eval_records(str(tmp_path))
    assert [r["name"] for r in loaded] == ["run", "run"]
    assert grids.load_eval_records(str(tmp_path / "none")) == []


def test_port_never_imports_pil():
    code = ("import sys\n"
            "import repro_torch.eval, repro_torch.launch.eval\n"
            "import numpy as np, tempfile, os\n"
            "from repro_torch.eval import grids\n"
            "d = tempfile.mkdtemp()\n"
            "grids.save_image_grid(os.path.join(d, 'g.png'),"
            " np.zeros((2, 4, 4, 3), np.float32))\n"
            "print('PIL' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


# ------------------------------------------------------------- workbench
def _eval_cfgs(tmp_path, **extra):
    kw = dict(dataset="synthetic", smoke=True, steps=2, eval_rows=12,
              inpaint_rows=2, num_samples=4, max_batch=REF_MAX_BATCH,
              out_dir=str(tmp_path), **extra)
    return (workbench.EvalConfig(device="cpu", run_name="port", **kw),
            ref_wb.EvalConfig(run_name="ref", **kw))


def _keys(rec):
    """The record's key tree (values dropped)."""
    return {k: _keys(v) if isinstance(v, dict) and k != "engine_stats"
            else None for k, v in rec.items()}


@pytest.fixture(scope="module")
def eval_records(pd_pair, mix_pair, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    out = {}
    for name, (ref, params, port) in (("single", pd_pair),
                                       ("mixture", mix_pair)):
        pcfg, rcfg = _eval_cfgs(tmp / name)
        out[name] = (workbench.run_eval(pcfg, model=port),
                     ref_wb.run_eval(rcfg, model=ref, params=params))
    return out


@pytest.mark.parametrize("which", ["single", "mixture"])
def test_run_eval_with_converted_model_matches_reference(eval_records, which):
    got, want = eval_records[which]
    assert got["parity_mismatches_total"] == 0
    assert _keys(got) == _keys(want)
    assert got["num_params"] == want["num_params"]
    assert got["train_steps"] == 0 and got["train_ll_first"] is None
    assert got["mixture_components"] == want["mixture_components"]
    for part in ("bpd_joint", "bpd_marginal"):
        np.testing.assert_allclose(got[part]["mean_ll"],
                                   want[part]["mean_ll"], rtol=1e-5)
    assert got["bpd_marginal"]["evidence_dims"] == \
        want["bpd_marginal"]["evidence_dims"]
    for mk, m in want["inpainting"]["per_mask"].items():
        for key in ("mpe_mse", "mean_fill_mse"):
            np.testing.assert_allclose(
                got["inpainting"]["per_mask"][mk][key], m[key], rtol=1e-5)
    for path in got["artifacts"].values():
        assert os.path.isfile(path)


def test_run_eval_smoke_trains_and_writes(tmp_path, eval_records):
    pcfg, _ = _eval_cfgs(tmp_path, mask_kinds=("left_half", "random_pixel"))
    rec = workbench.run_eval(pcfg)
    assert rec["parity_mismatches_total"] == 0
    assert rec["train_steps"] == 2
    assert rec["train_ll_last"] > rec["train_ll_first"]
    assert rec["bpd_joint"]["num_rows"] == 12
    assert np.isfinite(rec["bpd_joint"]["bpd"])
    # the reference's record layout, key for key (its per-mask dict and
    # artifacts have all four masks)
    want = _keys(eval_records["single"][1])
    want["inpainting"]["per_mask"] = {k: want["inpainting"]["per_mask"][k]
                                      for k in pcfg.mask_kinds}
    want["artifacts"] = {k: None for k in want["artifacts"]
                         if not k.startswith("inpaint_")
                         or k[len("inpaint_"):] in pcfg.mask_kinds}
    assert _keys(rec) == want
    for name in ("metrics.json", "samples.png", "inpaint_left_half.png",
                 "inpaint_random_pixel.png"):
        assert os.path.isfile(tmp_path / "port" / name)
    assert json.loads((tmp_path / "port" / "metrics.json").read_text()
                      )["run_name"] == "port"
    with pytest.raises(KeyError):
        workbench.run_eval(workbench.EvalConfig(dataset="cifar",
                                                device="cpu"))


def test_run_eval_needs_a_card_without_device_cpu(pd_pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        workbench.run_eval(workbench.EvalConfig(smoke=True))
    with pytest.raises(ValueError, match="model is on"):
        workbench.run_eval(workbench.EvalConfig(smoke=True, device="meta"),
                           model=pd_pair[2])


def test_eval_cli_smoke_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.eval", "--dataset",
           "synthetic", "--smoke", "--device", "cpu", "--out-dir",
           str(tmp_path), "--trace", str(tmp_path / "trace.json")]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "parity mismatches 0" in out.stdout
    assert "[obs] serve:" in out.stdout and "train: 25 steps" in out.stdout
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert {"serve.step", "eval.inpaint", "train.step"} <= {
        e["name"] for e in trace["traceEvents"]}
    assert (tmp_path / "synthetic_normal_smoke" / "metrics.json").is_file()
    if not torch.cuda.is_available():
        bad = subprocess.run(cmd[:5], env=env, capture_output=True,
                             text=True, timeout=120, cwd=tmp_path)
        assert bad.returncode != 0 and "--device cpu" in bad.stderr


# ----------------------------------------------------- obs and the engine
def test_histogram_buckets_and_percentiles_equal_reference():
    rng = np.random.RandomState(0)
    samples = np.concatenate([10.0 ** rng.uniform(-8, 5, 500), [0.0, -1.0,
                                                                  1e-7, 1e4]])
    got, want = obs.Histogram(), ref_obs.Histogram()
    for v in samples:
        got.record(v)
        want.record(v)
    assert got.counts() == want.counts()
    assert obs.metrics.NUM_BUCKETS == ref_obs.metrics.NUM_BUCKETS
    for q in (0, 1, 50, 90, 95, 99, 100):
        assert got.percentile(q) == want.percentile(q)
        assert obs.percentile_from_counts(got.counts(), q) == \
            ref_obs.percentile_from_counts(want.counts(), q)
    assert (got.count, got.vmin, got.vmax) == (want.count, want.vmin,
                                               want.vmax)


def test_export_trace_writes_spans(tmp_path):
    obs.reset()
    obs.configure(trace=True)
    try:
        with obs.span("outer", k=1):
            with obs.timed("inner", metric="test.inner.seconds") as t:
                obs.event("mark")
    finally:
        obs.configure(trace=False)
    assert t.seconds >= 0
    with obs.span("off"):
        pass
    doc = json.loads(Path(obs.export_trace(str(tmp_path / "t.json")))
                     .read_text())
    names = [e["name"] for e in doc["traceEvents"]]
    assert names == ["mark", "inner", "outer"]
    assert doc["otherData"]["dropped_events"] == 0
    assert obs.num_events() == 3 and obs.dropped_events() == 0
    obs.reset()
    assert obs.num_events() == 0


def test_engine_warmup_programs_and_request_metrics(pd_pair):
    _, _, port = pd_pair
    engine = ServeEngine(port, max_batch=4)
    assert engine.num_programs == 0
    secs = engine.warmup(kinds=["joint_ll", "mpe"])
    assert isinstance(secs, float) and secs >= 0
    assert engine.num_programs == 2 * len(engine.buckets)
    assert engine.stats["requests"] == 0  # filler rows are not requests
    before = sum(obs.METRICS.sum_histogram("serve.request.seconds"))
    rng = np.random.RandomState(0)
    reqs = [Request(req_id=i, kind="conditional_sample",
                    x=rng.rand(D).astype(np.float32),
                    evidence_mask=rng.rand(D) < 0.5, seed=i)
            for i in range(7)]
    engine.run(reqs)
    assert sum(obs.METRICS.sum_histogram("serve.request.seconds")) \
        - before == 7
    # 7 requests at max_batch 4: buckets 4 and 4 (3 rows padded)
    assert engine.num_programs == 2 * len(engine.buckets) + 1
    assert "serve" in obs.format_summary()


def test_mixture_warmup_runs_each_component(mix_pair):
    _, _, port = mix_pair
    engine = ServeEngine(port, max_batch=2)
    engine.warmup(kinds=["mixture_component_ll"], buckets=[1])
    assert engine.num_programs == port.num_components
    engine.warmup(kinds=["mixture_component_ll"], components=[1])
    assert engine.num_programs == port.num_components + 1


@pytest.mark.parametrize("which", ["single", "hard mixture",
                                   "soft mixture"])
def test_fit_records_train_metrics(which):
    x = torch.rand(16, D)
    if which == "single":
        lls_of = lambda: fit(_port_einet(), [x, x, x])  # noqa: E731
        rows = 16
    else:
        mix = EiNetMixture(_port_einet(), 2)
        hard = which == "hard mixture"
        xs = torch.stack([x, x.flip(0)]) if hard else x
        lls_of = lambda: fit_mixture(  # noqa: E731
            mix, [xs] * 3, MixtureTrainConfig(assign="hard" if hard
                                              else "soft"))
        rows = 32 if hard else 16
    before = sum(obs.METRICS.sum_histogram("train.step.seconds"))
    ex = obs.METRICS.value("train.examples.count")
    lls = lls_of()
    assert sum(obs.METRICS.sum_histogram("train.step.seconds")) - before == 3
    assert obs.METRICS.value("train.examples.count") - ex == 3 * rows
    assert obs.METRICS.value("train.ll.last") == lls[-1]
    assert obs.summary()["train_steps"] >= 3
