"""The port's examples (``examples/torch_*.py``) run on the CPU
(``--device cpu``) at small settings through their ``main(argv)``:
the quickstart prints what the reference's prints, line for line; the
multi-job service trains through an arrival and an exit; the LM driver
resumes from its saved step; the decode example serves through two
replicas."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_what_the_reference_prints(capsys):
    _example("torch_quickstart").main([])
    got = capsys.readouterr().out.splitlines()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    want = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart.py")], env=env,
        capture_output=True, text=True, check=True, timeout=300
    ).stdout.splitlines()
    assert len(got) == 7 and got == want


def test_multi_job_service_trains_through_arrival_and_exit(capsys):
    out = _example("torch_multi_job_service").main(
        ["--device", "cpu", "--steps", "30"])
    text = capsys.readouterr().out
    assert "-- probe job arrived" in text and "-- probe job exited" in text
    assert out["migrated"]["exit"] > 0 and out["n_replans"] == 3
    for job in ("mlp", "lm"):
        losses = [l for _, l in out["losses"][job]]
        assert len(losses) == 30 and all(np.isfinite(losses))
        # falling across both replans: the last third under the first
        assert np.mean(losses[20:]) < np.mean(losses[:10]), (job, losses)
    probe = [i for i, _ in out["losses"]["probe"]]
    assert probe == list(range(10, 20))
    assert out["stats"].n_ticks > 0 and out["stats"].n_applied == 70


def test_train_lm_e2e_resumes_from_its_saved_step(tmp_path, capsys):
    main = _example("torch_train_lm_e2e").main
    argv = ["--device", "cpu", "--smoke", "--fused-adam", "--batch", "2",
            "--seq", "16", "--save-every", "3", "--ckpt-dir", str(tmp_path)]
    first = main(argv + ["--steps", "4"])
    assert first["resumed_from"] is None and first["steps"] == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000000", "step_00000003"]
    second = main(argv + ["--steps", "6"])
    text = capsys.readouterr().out
    assert second["resumed_from"] == 3 and second["steps"] == 2
    assert "resumed from checkpoint step 3" in text
    assert np.isfinite(second["last_loss"])


def test_serve_decode_reads_weights_through_two_replicas(capsys):
    out = _example("torch_serve_decode").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "read through 2 pull replicas (bit-exact vs hosted)" in text
    assert tuple(out["tokens"].shape) == (4, 24)
