"""Entry points off the accelerator: the compile cache's place, the device
feed's memory budget, serve's trainer arguments, the main path without
flax, and chip_smoke.py refusing a CPU backend."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest

from rsrgan_jax.cli import REPO_ROOT, enable_compile_cache
from rsrgan_jax.cli import serve as serve_cli
from rsrgan_jax.cli import train as train_cli


def _child_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO_ROOT
    return env


class TestCompileCache:
    def test_env_dir_is_left_to_jax(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "somewhere")
        assert enable_compile_cache() == "somewhere"
        assert calls == []

    def test_default_is_fixed_dir_in_checkout(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO_ROOT, ".jax_cache")
        assert enable_compile_cache() == want
        assert calls == [("jax_compilation_cache_dir", want)]
        assert os.path.isfile(os.path.join(REPO_ROOT, "chip_smoke.py"))


class _Device:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


class TestFeedMemoryBudget:
    def test_from_bytes_limit(self, monkeypatch):
        monkeypatch.delenv("RSRGAN_FEED_HBM_BUDGET", raising=False)
        budget = train_cli.feed_memory_budget(
            _Device({"bytes_limit": 60_000_000_000}))
        assert budget == 60e9 * (1 - train_cli.FEED_WORKING_SET_SHARE)

    def test_no_stats_is_an_error(self, monkeypatch):
        monkeypatch.delenv("RSRGAN_FEED_HBM_BUDGET", raising=False)
        for stats in (None, {}):
            with pytest.raises(SystemExit, match="no memory statistics"):
                train_cli.feed_memory_budget(_Device(stats))

    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("RSRGAN_FEED_HBM_BUDGET", "12345")
        assert train_cli.feed_memory_budget(_Device(None)) == 12345.0

    def test_auto_is_off_on_cpu(self):
        args = train_cli.build_parser().parse_args(
            ["--trainer=gan_rnn", "--device_feed=auto"])
        assert train_cli.decide_device_feed(args, None, None, None, 1) \
            is None


@pytest.mark.parametrize("trainer,d_conditioned", [
    ("gan_rnn", False), ("gan_rnn", True), ("rnn", False)])
def test_serve_args_satisfy_build_trainer(trainer, d_conditioned):
    """serve builds the trainer to restore the checkpoint tree; the
    conditioning that widens D's input comes from the checkpoint's
    sidecar."""
    args, _ = serve_cli.build_parser().parse_known_args([
        "--save_dir=x", "--data_dir=x", "--test_list_file=x",
        f"--trainer={trainer}", "--input_dim=8", "--output_dim=4"])
    serve_cli.apply_checkpoint_meta(args, {"d_conditioned": d_conditioned})
    built = train_cli.build_trainer(args, jnp.float32)
    assert getattr(built, "d_conditioned", False) is d_conditioned
    serve_cli.apply_checkpoint_meta(args, None)
    assert args.d_conditioned is False


def test_main_path_runs_without_flax(tmp_path):
    """gan_rnn trains, checkpoints and decodes with flax unimportable; a
    flax model then fails naming the package."""
    code = textwrap.dedent(f"""
        import os, sys
        sys.modules["flax"] = None
        from rsrgan_jax.cli import prepare, train
        from rsrgan_jax.data.synthetic import make_synthetic_corpus
        d = {str(tmp_path)!r}
        make_synthetic_corpus(d, num_utts=6, input_dim=8, output_dim=3,
                              min_len=20, max_len=30)
        assert prepare.main(["cmvn", f"--inputs={{d}}/inputs.cmvn",
                             f"--labels={{d}}/labels.cmvn",
                             f"--save_dir={{d}}"]) == 0
        assert prepare.main(["split", "--val_size=2", f"--data_dir={{d}}",
                             "--seed=1"]) == 0
        for sub in ("tr", "cv"):
            assert prepare.main([
                "make-store", f"--inputs={{d}}/{{sub}}/inputs.scp",
                f"--labels={{d}}/{{sub}}/labels.scp", f"--cmvn_dir={{d}}",
                f"--output_dir={{d}}/stores", f"--name={{sub}}"]) == 0
            with open(f"{{d}}/{{sub}}.list", "w") as f:
                f.write(f"{{d}}/stores/{{sub}}.rtu\\n")
        common = ["--trainer=gan_rnn", "--g_type=res_lstm_l",
                  f"--data_dir={{d}}", f"--save_dir={{d}}/exp",
                  "--input_dim=8", "--output_dim=3", "--bf16=false"]
        assert train.main(common + [
            f"--tr_list_file={{d}}/tr.list", f"--cv_list_file={{d}}/cv.list",
            "--batch_size=2", "--min_epoches=1", "--max_epoches=1",
            "--tensorboard=false"]) == 0
        assert train.main(common + ["--decode",
                                    f"--test_list_file={{d}}/cv.list"]) == 0
        assert os.path.getsize(f"{{d}}/exp/test/feats.ark") > 0
        assert "flax" not in [m.split(".")[0] for m in sys.modules
                              if sys.modules[m] is not None]
        from rsrgan_jax.models import get_generator
        try:
            get_generator("dnn", input_dim=8, output_dim=3)
        except ImportError as e:
            assert "'flax' package" in str(e), e
        else:
            raise AssertionError("dnn built without flax")
        print("NO_FLAX_OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], env=_child_env(),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "NO_FLAX_OK" in r.stdout, \
        r.stdout[-3000:] + r.stderr[-3000:]


def test_chip_smoke_refuses_cpu(tmp_path):
    r = subprocess.run([sys.executable,
                        os.path.join(REPO_ROOT, "chip_smoke.py")],
                       env=_child_env(), cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr
