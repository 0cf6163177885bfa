"""Device-resident feed: on-device gather parity with the host batcher,
equality of the gathered train/eval steps vs the host-fed ones, and
CLI-level equivalence of --device_feed on/off.

The gathered path replaces the reference's host feed_dict boundary
(scripts/train_gan_rnn_placeholder.py:66-112) with gathers from resident
HBM tables; these tests pin that the replacement is semantically
invisible."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rsrgan_jax.data.dataset import (SequenceBatcher, bucket_id,
                                     padded_length)
from rsrgan_jax.data.device_feed import DeviceFeed, table_bytes
from rsrgan_jax.data.store import StoreWriter, UtteranceStore
from rsrgan_jax.models.discriminators import LstmDiscriminator
from rsrgan_jax.models.recurrent import ResLstmGenerator
from rsrgan_jax.ops.gather import gather_sequences
from rsrgan_jax.training import GanTrainer, MseTrainer

D_IN, D_OUT = 8, 8


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("feed") / "corpus.rtu")
    rng = np.random.default_rng(7)
    with StoreWriter(path) as w:
        for i, t in enumerate([30, 45, 33, 60, 41, 30, 52, 38, 47, min(260, 260)]):
            x = rng.normal(size=(t, D_IN)).astype(np.float32)
            y = rng.normal(size=(t, D_OUT)).astype(np.float32)
            w.add(f"utt{i}", x, y)
    return UtteranceStore(path)


def batch_t_pad(batcher, lengths):
    mx = int(np.max(lengths))
    return padded_length(bucket_id(mx, batcher.num_buckets), mx,
                         batcher.num_buckets)


class TestGatherParity:
    @pytest.mark.parametrize("left,right", [(0, 0), (2, 1)])
    def test_matches_host_batcher(self, store, left, right):
        feed = DeviceFeed(store)
        batcher = SequenceBatcher(store, 3, left, right, shuffle=False,
                                  drop_remainder=False)
        plans = list(batcher.iter_index_batches())
        batches = list(batcher)
        assert len(plans) == len(batches) >= 2
        for indices, batch in zip(plans, batches):
            st, le = feed.plan(indices)
            t_pad = batch_t_pad(batcher, le)
            assert batch.inputs.shape[1] == t_pad
            x = np.asarray(gather_sequences(feed.inputs_tbl,
                                            jnp.asarray(st),
                                            jnp.asarray(le), t_pad,
                                            left, right, dim=feed.in_dim))
            y = np.asarray(gather_sequences(feed.labels_tbl,
                                            jnp.asarray(st),
                                            jnp.asarray(le), t_pad,
                                            dim=feed.out_dim))
            np.testing.assert_array_equal(x, batch.inputs)
            np.testing.assert_array_equal(y, batch.labels)

    def test_bf16_tables_quantize_only(self, store):
        feed32 = DeviceFeed(store)
        feed16 = DeviceFeed(store, dtype=jnp.bfloat16)
        assert feed16.num_bytes * 2 == feed32.num_bytes
        st, le = feed16.plan([0, 3])
        x16 = np.asarray(gather_sequences(feed16.inputs_tbl,
                                          jnp.asarray(st), jnp.asarray(le),
                                          100, dim=feed16.in_dim))
        x32 = np.asarray(gather_sequences(feed32.inputs_tbl,
                                          jnp.asarray(st), jnp.asarray(le),
                                          100, dim=feed32.in_dim))
        assert x16.dtype == np.float32  # always upcast after gather
        np.testing.assert_allclose(x16, x32, rtol=1e-2, atol=1e-2)

    def test_table_bytes_estimate(self, store):
        feed = DeviceFeed(store)
        assert table_bytes(store, 4) == feed.num_bytes

    def test_tables_are_tile_padded(self, store):
        """Widths are 128-lane aligned (row-major == compact layout, so
        the AOT compiler never relayouts the tables inside the train
        program — the round-4 phase-A OOM); pad columns are zero."""
        feed = DeviceFeed(store)
        assert feed.inputs_tbl.shape[1] == 128 and feed.in_dim == D_IN
        assert feed.labels_tbl.shape[1] == 128 and feed.out_dim == D_OUT
        tail = np.asarray(feed.inputs_tbl[:, D_IN:])
        assert not tail.any()

    def test_small_chunks_match_single_upload(self, store):
        one = DeviceFeed(store)
        many = DeviceFeed(store, chunk_bytes=1024)  # forces ~dozens of puts
        np.testing.assert_array_equal(np.asarray(one.inputs_tbl),
                                      np.asarray(many.inputs_tbl))


class TestWireDtype:
    def test_f16_wire_within_one_bf16_ulp(self):
        """bf16 tables ship f32->f16 on the wire, then cast to bf16 on
        device (device_feed.wire_dtype_for). Double rounding can flip the
        terminal bf16 bit on values within an f16 half-ulp of a bf16
        rounding midpoint; pin that the wire path never strays more than
        1 bf16 ulp from direct f32->bf16 — including adversarial values
        seeded AT bf16 midpoints, where the divergence concentrates."""
        rng = np.random.default_rng(3)
        vals = rng.normal(size=4096).astype(np.float32) * 8
        # adversarial: exact bf16 midpoints +- a tiny f32 perturbation
        base = rng.normal(size=4096).astype(np.float32)
        as_bf16 = base.astype(jnp.bfloat16.dtype)
        ulp = np.abs(
            np.nextafter(as_bf16.astype(np.float32), np.inf)
            - as_bf16.astype(np.float32))
        mid = as_bf16.astype(np.float32) + 0.5 * ulp
        eps = np.float32(1e-4) * ulp
        vals = np.concatenate([vals, mid - eps, mid, mid + eps])

        direct = vals.astype(jnp.bfloat16.dtype)
        wired = vals.astype(np.float16).astype(jnp.bfloat16.dtype)
        # bf16 neighbors of the direct quantization (jnp.nextafter
        # supports bfloat16; numpy's does not)
        lo = np.asarray(jnp.nextafter(direct, jnp.bfloat16(-np.inf)),
                        np.float32)
        hi = np.asarray(jnp.nextafter(direct, jnp.bfloat16(np.inf)),
                        np.float32)
        w = wired.astype(np.float32)
        ok = (lo <= w) & (w <= hi)
        assert ok.all(), (
            f"f16 wire drifted >1 bf16 ulp from direct quantization on "
            f"{(~ok).sum()} of {ok.size} values")

    def test_env_override_forces_f32_wire(self, store, monkeypatch):
        """RSRGAN_FEED_WIRE_DTYPE=float32 makes the bf16 table EXACTLY
        the direct f32->bf16 quantization (no double rounding)."""
        monkeypatch.setenv("RSRGAN_FEED_WIRE_DTYPE", "float32")
        feed = DeviceFeed(store, dtype=jnp.bfloat16)
        got = np.asarray(feed.inputs_tbl[:3, :D_IN].astype(jnp.float32))
        want = store.inputs(0)[:3].astype(jnp.bfloat16.dtype) \
            .astype(np.float32)
        np.testing.assert_array_equal(got, want)


def stack_plans(feed, plans):
    starts = np.stack([feed.plan(p)[0] for p in plans])
    lens = np.stack([feed.plan(p)[1] for p in plans])
    return jnp.asarray(starts), jnp.asarray(lens)


HP = {"g_lr": jnp.float32(1e-3), "d_lr": jnp.float32(1e-3),
      "mse_lambda": jnp.float32(10.0), "disc_noise_std": jnp.float32(0.05),
      "d_real": jnp.float32(1.0), "d_fake": jnp.float32(0.0)}


class TestGatheredSteps:
    def _setup(self, store, trainer_kind):
        gen = ResLstmGenerator(output_dim=D_OUT, variant="l", cell_size=12)
        if trainer_kind == "gan":
            disc = LstmDiscriminator(cell_size=8, num_projection=4)
            trainer = GanTrainer(gen, disc, output_dim=D_OUT, input_dim=D_IN,
                                 disc_updates=1, gen_updates=2,
                                 l2_scale=1e-5)
        else:
            trainer = MseTrainer(gen, output_dim=D_OUT, l2_scale=1e-5,
                                 max_grad_norm=15.0)
        feed = DeviceFeed(store)
        batcher = SequenceBatcher(store, 2, shuffle=False,
                                  drop_remainder=True)
        plans = [p for p in batcher.iter_index_batches()
                 if batch_t_pad(batcher, feed.plan(p)[1]) == 50][:2]
        assert len(plans) == 2
        batches = [batcher._make_batch(p, t_pad=50) for p in plans]
        stacked = (jnp.asarray(np.stack([b.inputs for b in batches])),
                   jnp.asarray(np.stack([b.labels for b in batches])),
                   jnp.asarray(np.stack([b.lengths for b in batches])))
        state = trainer.init_state(jax.random.PRNGKey(0),
                                   jnp.asarray(batches[0].inputs),
                                   jnp.asarray(batches[0].lengths))
        return trainer, feed, plans, stacked, state

    def test_gan_multi_step_matches_host(self, store):
        trainer, feed, plans, stacked, state = self._setup(store, "gan")
        rng = jax.random.PRNGKey(42)
        starts, lens = stack_plans(feed, plans)
        s_host, m_host = trainer.train_multi_step(state, *stacked, HP, rng)
        state2 = trainer.init_state(jax.random.PRNGKey(0),
                                    stacked[0][0], stacked[2][0])
        s_dev, m_dev = trainer.train_multi_step_gathered(
            state2, feed.inputs_tbl, feed.labels_tbl, starts, lens, HP,
            rng, 50, 0, 0, feed.in_dim, feed.out_dim)
        for a, b in zip(jax.tree.leaves(s_host.g.params),
                        jax.tree.leaves(s_dev.g.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)
        for k in m_host:
            np.testing.assert_allclose(float(m_host[k]), float(m_dev[k]),
                                       rtol=1e-5, atol=1e-6)

    def test_mse_multi_step_and_eval_match_host(self, store):
        trainer, feed, plans, stacked, state = self._setup(store, "mse")
        rng = jax.random.PRNGKey(9)
        starts, lens = stack_plans(feed, plans)
        lr = jnp.float32(1e-3)
        s_host, m_host = trainer.train_multi_step(state, *stacked, lr, rng)
        state2 = trainer.init_state(jax.random.PRNGKey(0),
                                    stacked[0][0], stacked[2][0])
        s_dev, m_dev = trainer.train_multi_step_gathered(
            state2, feed.inputs_tbl, feed.labels_tbl, starts, lens, lr,
            rng, 50, 0, 0, feed.in_dim, feed.out_dim)
        for a, b in zip(jax.tree.leaves(s_host.net.params),
                        jax.tree.leaves(s_dev.net.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)
        # gathered eval == mean of per-batch host evals
        host_evals = [trainer.eval_step(s_host, stacked[0][i],
                                        stacked[1][i], stacked[2][i])
                      for i in range(2)]
        m_eval = trainer.eval_multi_step_gathered(
            s_dev, feed.inputs_tbl, feed.labels_tbl, starts, lens,
            50, 0, 0, feed.in_dim, feed.out_dim)
        for k in m_eval:
            want = np.mean([float(m[k]) for m in host_evals])
            np.testing.assert_allclose(float(m_eval[k]), want,
                                       rtol=1e-5, atol=1e-6)


class TestCliDeviceFeed:
    def test_on_off_equivalence(self, tmp_path, monkeypatch):
        """cli/train with --device_feed=on must reproduce the host-fed
        run's loss trajectory (same seed, same corpus)."""
        # CPU devices report no memory statistics to size the tables by
        monkeypatch.setenv("RSRGAN_FEED_HBM_BUDGET", "1e9")
        from rsrgan_jax.cli import prepare as prepare_cli
        from rsrgan_jax.cli import train as train_cli
        from rsrgan_jax.data.synthetic import make_synthetic_corpus

        data_dir = str(tmp_path / "data")
        make_synthetic_corpus(data_dir, num_utts=10, input_dim=12,
                              output_dim=5, min_len=30, max_len=60, seed=3)
        assert prepare_cli.main(
            ["cmvn", f"--inputs={data_dir}/inputs.cmvn",
             f"--labels={data_dir}/labels.cmvn",
             f"--save_dir={data_dir}"]) == 0
        assert prepare_cli.main(["split", "--val_size=4",
                                 f"--data_dir={data_dir}", "--seed=1"]) == 0
        stores = os.path.join(data_dir, "stores")
        for sub in ("tr", "cv"):
            assert prepare_cli.main([
                "make-store", f"--inputs={data_dir}/{sub}/inputs.scp",
                f"--labels={data_dir}/{sub}/labels.scp",
                f"--cmvn_dir={data_dir}", f"--output_dir={stores}",
                f"--name={sub}"]) == 0
            with open(os.path.join(data_dir, f"{sub}.list"), "w") as f:
                f.write(os.path.join(stores, f"{sub}.rtu") + "\n")

        results = {}
        for mode in ("off", "on"):
            save_dir = str(tmp_path / f"exp_{mode}")
            rc = train_cli.main([
                "--trainer=rnn", "--g_type=lstm",
                f"--data_dir={data_dir}",
                f"--tr_list_file={os.path.join(data_dir, 'tr.list')}",
                f"--cv_list_file={os.path.join(data_dir, 'cv.list')}",
                f"--save_dir={save_dir}",
                "--input_dim=12", "--output_dim=5", "--batch_size=2",
                "--g_learning_rate=0.0005",
                "--min_epoches=1", "--max_epoches=2", "--bf16=false",
                "--steps_per_call=2", f"--device_feed={mode}",
                "--tensorboard=false", "--seed=5"])
            assert rc == 0
            rows = []
            with open(os.path.join(save_dir, "metrics_eval.jsonl")) as f:
                for line in f:
                    rows.append(json.loads(line))
            results[mode] = rows
        assert len(results["on"]) == len(results["off"]) == 2
        for r_on, r_off in zip(results["on"], results["off"]):
            for k in ("g_mse_loss", "g_loss"):
                np.testing.assert_allclose(r_on[k], r_off[k], rtol=1e-5)
