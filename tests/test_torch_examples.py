"""The port's three examples (``examples/*_torch.py``) on the CPU at
reduced sizes, through their ``main(argv)``, with the assertions
``chip_smoke.py`` makes at their default sizes on the card: quickstart's
LL rises over its epochs; inpainting keeps every observed pixel exactly
and decodes the rest better than mean-fill; a train_density run killed
mid-way restarts from its checkpoint and ends at the uninterrupted run's
LL bit for bit."""

import importlib.util
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def example(name):
    path = os.path.join(ROOT, "examples", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_learns_and_answers_every_kind():
    out = example("quickstart").main(
        ["--device", "cpu", "--rows", "512", "--batch", "128",
         "--epochs", "3"])
    assert out["epoch_lls"][-1] > out["epoch_lls"][0]
    assert np.isfinite(out["joint_ll"]).all()
    # marginal LLs of half the variables lie above the joint's
    assert (out["marginal_ll"] > out["joint_ll"]).all()
    np.testing.assert_allclose(out["conditional_ll"],
                               out["joint_ll"] - out["marginal_ll"],
                               rtol=1e-5, atol=1e-4)
    ev = out["evidence_mask"]
    for kind in ("conditional_sample", "mpe"):
        assert np.array_equal(out[kind][ev], out["x"][ev])
    assert out["sample"].shape == out["x"].shape


def test_inpainting_keeps_observed_pixels(tmp_path):
    out = example("image_inpainting").main(
        ["--device", "cpu", "--train-rows", "512", "--test-rows", "8",
         "--batch", "128", "--epochs", "2", "--num-sums", "4",
         "--out", str(tmp_path)])
    assert set(out["masks"]) == {"left_half", "top_half", "sparse_25pct"}
    for name, m in out["masks"].items():
        assert m["observed_kept"], name
        assert m["mse"] < m["mean_fill_mse"], name
        assert (tmp_path / f"inpainted_{name}.npy").exists()
    assert out["samples_finite"]
    assert np.load(tmp_path / "samples.npy").shape == (16, 16, 16, 3)


DENSITY = ["--device", "cpu", "--steps", "12", "--batch", "32",
           "--num-sums", "4", "--depth", "3", "--reps", "2", "--rows", "512",
           "--checkpoint-every", "4"]


@pytest.mark.parametrize("kill_at", [2, 7])
def test_train_density_restart_ends_at_the_uninterrupted_ll(tmp_path,
                                                             kill_at):
    """Killed before the first checkpoint (replay from the initial
    parameters) and after one (restore step 4)."""
    mod = example("train_density")
    plain = mod.main(DENSITY + ["--ckpt-dir", str(tmp_path / "a")])
    killed = mod.main(DENSITY + ["--kill-at", str(kill_at),
                                 "--ckpt-dir", str(tmp_path / "b")])
    assert plain["restarts"] == 0 and killed["restarts"] == 1
    assert killed["final_test_ll"] == plain["final_test_ll"]
    assert killed["lls"] == plain["lls"]
    assert killed["checkpoints"] == plain["checkpoints"] == [8, 12]
    assert plain["last10"] > plain["first10"]


def test_examples_default_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    for name in ("quickstart", "image_inpainting", "train_density"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            example(name).main([])
