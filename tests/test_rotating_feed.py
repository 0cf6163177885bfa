"""Rotating device feed (corpora beyond the HBM budget) and the
device-feed x data-mesh composition.

Round-4 VERDICT #3: the device feed must compose with multi-chip DP
(tables replicated, batch plans sharded) and with corpora whose tables
exceed HBM (resident-shard rotation) instead of silently reverting to
the ~30x slower host feed. These tests pin both: shard rotation is
semantically invisible (bit-equal gathers vs the host batcher after any
rotation sequence), and DP-with-device-feed equals the single-device
run on the virtual CPU mesh."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rsrgan_jax.data.dataset import SequenceBatcher, bucket_id, padded_length
from rsrgan_jax.data.device_feed import (DeviceFeed, RotatingDeviceFeed,
                                         pad_dim, table_bytes)
from rsrgan_jax.data.store import StoreView, StoreWriter, UtteranceStore
from rsrgan_jax.models.recurrent import ResLstmGenerator
from rsrgan_jax.ops.gather import gather_sequences
from rsrgan_jax.parallel import make_mesh, shard_batch, replicate
from rsrgan_jax.training import MseTrainer

D_IN, D_OUT = 8, 6
LENS = [30, 45, 33, 60, 41, 30, 52, 38, 47, 55, 36, 44,
        29, 61, 40, 35, 58, 31, 49, 42, 37, 53, 34, 46]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rot") / "corpus.rtu")
    rng = np.random.default_rng(11)
    with StoreWriter(path) as w:
        for i, t in enumerate(LENS):
            x = rng.normal(size=(t, D_IN)).astype(np.float32)
            y = rng.normal(size=(t, D_OUT)).astype(np.float32)
            w.add(f"utt{i:02d}", x, y)
    return UtteranceStore(path)


def rows_budget(n_rows: int, n_buffers: int = 1) -> int:
    """Budget that fits exactly ``n_rows`` frames per shard buffer."""
    bpf = (pad_dim(D_IN) + pad_dim(D_OUT)) * 4
    return (n_rows + 1) * bpf * n_buffers


def t_pad_for(batcher, lengths):
    mx = int(np.max(lengths))
    return padded_length(bucket_id(mx, batcher.num_buckets), mx,
                         batcher.num_buckets)


class TestStoreView:
    def test_delegates_subset(self, store):
        ix = [3, 0, 7, 12]
        v = StoreView(store, ix)
        assert len(v) == 4
        assert v.utt_ids == [store.utt_ids[i] for i in ix]
        np.testing.assert_array_equal(v.lengths, store.lengths[ix])
        assert (v.input_dim, v.output_dim, v.has_labels) == (D_IN, D_OUT,
                                                             True)
        np.testing.assert_array_equal(v.inputs(2), store.inputs(7))
        np.testing.assert_array_equal(v.labels(1), store.labels(0))

    def test_batcher_over_view(self, store):
        """SequenceBatcher on a view == batcher output restricted to the
        view's utterances (shuffle off, same bucket logic)."""
        ix = np.arange(0, 12)
        v = StoreView(store, ix)
        bv = SequenceBatcher(v, 2, shuffle=False, drop_remainder=False)
        bs = SequenceBatcher(store, 2, shuffle=False, drop_remainder=False)
        got = [b for b in bv]
        # same utts through the store batcher limited to the first 12
        want_ids = {store.utt_ids[i] for i in ix}
        got_ids = {u for b in got for u in b.utt_ids}
        assert got_ids == want_ids
        assert bv.num_batches() <= bs.num_batches()


class TestPartition:
    def test_covers_disjoint_within_cap(self, store):
        cap = int(store.lengths.sum()) // 3
        feed = RotatingDeviceFeed(store, jnp.float32, rows_budget(cap))
        seen = np.concatenate(feed.shards)
        assert sorted(seen.tolist()) == list(range(len(store)))
        assert feed.num_shards >= 3
        for k, s in enumerate(feed.shards):
            assert store.lengths[s].sum() <= cap
            assert feed._shard_rows[k] == int(store.lengths[s].sum())
        assert feed.max_rows == max(feed._shard_rows)

    def test_longest_utt_must_fit(self, store):
        with pytest.raises(ValueError, match="longest utterance"):
            RotatingDeviceFeed(store, jnp.float32, rows_budget(20))

    def test_schedule_exact_passes(self, store):
        feed = RotatingDeviceFeed(store, jnp.float32,
                                  rows_budget(int(store.lengths.sum()) // 3))
        for block in (1, 2, 5):
            visits = feed.schedule(epochs=5, block=block, seed=1)
            per_shard = np.zeros(feed.num_shards, np.int64)
            for k, p in visits:
                assert 1 <= p <= block
                per_shard[k] += p
            assert (per_shard == 5).all()

    def test_num_bytes_within_budget(self, store):
        budget = rows_budget(int(store.lengths.sum()) // 2)
        feed = RotatingDeviceFeed(store, jnp.float32, budget)
        assert feed.num_bytes <= budget
        both = RotatingDeviceFeed(store, jnp.float32, 2 * budget,
                                  prefetch=True)
        assert both.num_bytes <= 2 * budget


def assert_shard_gathers_match(feed, store, k, batch_size=3):
    """Every batch of shard k, gathered from the resident tables, must
    bit-match the host batcher over the same StoreView."""
    view = StoreView(store, feed.shards[k])
    batcher = SequenceBatcher(view, batch_size, shuffle=False,
                              drop_remainder=False)
    n = 0
    for indices, batch in zip(batcher.iter_index_batches(), batcher):
        st, le = feed.plan(indices)
        t_pad = t_pad_for(batcher, le)
        x = np.asarray(gather_sequences(feed.inputs_tbl, jnp.asarray(st),
                                        jnp.asarray(le), t_pad,
                                        dim=feed.in_dim))
        y = np.asarray(gather_sequences(feed.labels_tbl, jnp.asarray(st),
                                        jnp.asarray(le), t_pad,
                                        dim=feed.out_dim))
        np.testing.assert_array_equal(x, batch.inputs)
        np.testing.assert_array_equal(y, batch.labels)
        n += 1
    assert n >= 1


class TestRotation:
    def test_every_shard_matches_host(self, store):
        feed = RotatingDeviceFeed(store, jnp.float32,
                                  rows_budget(int(store.lengths.sum()) // 3))
        for k in range(feed.num_shards):
            feed.ensure_resident(k)
            assert_shard_gathers_match(feed, store, k)

    def test_refill_after_rotation_is_clean(self, store):
        """Rotating BACK to a previously resident shard re-fills the same
        donated buffer; shorter shards must not see the longer shard's
        stale rows."""
        feed = RotatingDeviceFeed(store, jnp.float32,
                                  rows_budget(int(store.lengths.sum()) // 3))
        order = list(range(feed.num_shards)) + [0, feed.num_shards - 1, 0]
        for k in order:
            feed.ensure_resident(k)
            assert feed._active_shard == k
            assert_shard_gathers_match(feed, store, k)
        # no consecutive repeats in `order`, so every visit re-uploads
        assert feed.uploads == len(order)

    def test_ensure_resident_is_idempotent(self, store):
        feed = RotatingDeviceFeed(store, jnp.float32,
                                  rows_budget(int(store.lengths.sum()) // 2))
        feed.ensure_resident(0)
        n = feed.uploads
        feed.ensure_resident(0)
        assert feed.uploads == n

    def test_prefetch_ping_pong(self, store):
        budget = rows_budget(int(store.lengths.sum()) // 2, n_buffers=2)
        feed = RotatingDeviceFeed(store, jnp.float32, budget, prefetch=True)
        assert feed.num_shards >= 2
        feed.ensure_resident(0)
        feed.start_prefetch(1)
        feed.ensure_resident(1)  # must consume the prefetched buffer
        assert_shard_gathers_match(feed, store, 1)
        feed.start_prefetch(0)
        feed.ensure_resident(0)
        assert_shard_gathers_match(feed, store, 0)

    def test_bf16_tables(self, store):
        feed = RotatingDeviceFeed(store, jnp.bfloat16,
                                  rows_budget(int(store.lengths.sum()) // 2)
                                  // 2)
        feed.ensure_resident(0)
        view = StoreView(store, feed.shards[0])
        st, le = feed.plan([0, 1])
        x = np.asarray(gather_sequences(feed.inputs_tbl, jnp.asarray(st),
                                        jnp.asarray(le), 70,
                                        dim=feed.in_dim))
        assert x.dtype == np.float32
        np.testing.assert_allclose(x[0, :le[0]], view.inputs(0),
                                   rtol=1e-2, atol=1e-2)


class TestMeshFeed:
    """Device feed composed with the data mesh (8 virtual CPU devices)."""

    def _trainer(self):
        gen = ResLstmGenerator(output_dim=D_OUT, variant="l", cell_size=12)
        return MseTrainer(gen, output_dim=D_OUT, l2_scale=1e-5,
                          max_grad_norm=15.0)

    def test_replicated_tables_gather_equal(self, store):
        mesh = make_mesh(4)
        feed_m = DeviceFeed(store, mesh=mesh)
        feed_1 = DeviceFeed(store)
        np.testing.assert_array_equal(np.asarray(feed_m.inputs_tbl),
                                      np.asarray(feed_1.inputs_tbl))
        st, le = feed_m.plan([0, 1, 2, 3])
        sh_st, sh_le = shard_batch(mesh, (jnp.asarray(st[None]),
                                          jnp.asarray(le[None])), axis=1)
        x = gather_sequences(feed_m.inputs_tbl, sh_st[0], sh_le[0], 70,
                             dim=feed_m.in_dim)
        want = gather_sequences(feed_1.inputs_tbl, jnp.asarray(st),
                                jnp.asarray(le), 70, dim=feed_1.in_dim)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(want))

    def test_dp_gathered_step_equals_single_device(self, store):
        """train_multi_step_gathered under a 4-way data mesh (replicated
        tables, batch-sharded plans) == the single-device step."""
        trainer = self._trainer()
        mesh = make_mesh(4)
        feed_m = DeviceFeed(store, mesh=mesh)
        feed_1 = DeviceFeed(store)
        batcher = SequenceBatcher(store, 4, shuffle=False,
                                  drop_remainder=True)
        plans = [p for p in batcher.iter_index_batches()][:2]
        assert len(plans) == 2
        st = np.stack([feed_1.plan(p)[0] for p in plans])
        le = np.stack([feed_1.plan(p)[1] for p in plans])
        t_pad = max(t_pad_for(batcher, le[i]) for i in range(2))
        rng = jax.random.PRNGKey(4)
        lr = jnp.float32(1e-3)

        example = batcher._make_batch(plans[0], t_pad=t_pad)
        state = trainer.init_state(jax.random.PRNGKey(0),
                                   jnp.asarray(example.inputs),
                                   jnp.asarray(example.lengths))
        s1, m1 = trainer.train_multi_step_gathered(
            state, feed_1.inputs_tbl, feed_1.labels_tbl, jnp.asarray(st),
            jnp.asarray(le), lr, rng, t_pad, 0, 0, feed_1.in_dim,
            feed_1.out_dim)

        state_m = replicate(mesh, trainer.init_state(
            jax.random.PRNGKey(0), jnp.asarray(example.inputs),
            jnp.asarray(example.lengths)))
        sh_st, sh_le = shard_batch(mesh, (jnp.asarray(st),
                                          jnp.asarray(le)), axis=1)
        sm, mm = trainer.train_multi_step_gathered(
            state_m, feed_m.inputs_tbl, feed_m.labels_tbl, sh_st, sh_le,
            lr, rng, t_pad, 0, 0, feed_m.in_dim, feed_m.out_dim)
        for a, b in zip(jax.tree.leaves(s1.net.params),
                        jax.tree.leaves(sm.net.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)
        for k in m1:
            np.testing.assert_allclose(float(m1[k]), float(mm[k]),
                                       rtol=1e-5, atol=1e-6)

    def test_rotating_feed_on_mesh(self, store):
        mesh = make_mesh(2)
        feed = RotatingDeviceFeed(
            store, jnp.float32,
            rows_budget(int(store.lengths.sum()) // 2), mesh=mesh)
        for k in (0, feed.num_shards - 1, 0):
            feed.ensure_resident(k)
            assert_shard_gathers_match(feed, store, k)


def _build_corpus(tmp_path, num_utts=12, val_size=3):
    from rsrgan_jax.cli import prepare as prepare_cli
    from rsrgan_jax.data.synthetic import make_synthetic_corpus

    data_dir = str(tmp_path / "data")
    make_synthetic_corpus(data_dir, num_utts=num_utts, input_dim=12,
                          output_dim=5, min_len=30, max_len=60, seed=3)
    assert prepare_cli.main(
        ["cmvn", f"--inputs={data_dir}/inputs.cmvn",
         f"--labels={data_dir}/labels.cmvn", f"--save_dir={data_dir}"]) == 0
    assert prepare_cli.main(["split", f"--val_size={val_size}",
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
    return data_dir


def _run_train(data_dir, save_dir, extra):
    from rsrgan_jax.cli import train as train_cli
    rc = train_cli.main([
        "--trainer=rnn", "--g_type=lstm", f"--data_dir={data_dir}",
        f"--tr_list_file={os.path.join(data_dir, 'tr.list')}",
        f"--cv_list_file={os.path.join(data_dir, 'cv.list')}",
        f"--save_dir={save_dir}",
        "--input_dim=12", "--output_dim=5",
        "--g_learning_rate=0.0005", "--bf16=false",
        "--tensorboard=false", "--seed=5"] + extra)
    assert rc == 0
    rows = []
    with open(os.path.join(save_dir, "metrics_eval.jsonl")) as f:
        for line in f:
            rows.append(json.loads(line))
    return rows


class TestCliRotation:
    def test_rotating_run_completes(self, tmp_path, monkeypatch):
        """cli/train with a budget too small for residency must rotate
        (not fall back to the host feed) and finish with finite losses;
        block mode redefines iterations as residencies."""
        from rsrgan_jax.cli import train as train_cli
        data_dir = _build_corpus(tmp_path)
        # tr is 9 utts x ~45 frames x (128+128) cols ~= 420 kB f32 /
        # 210 kB bf16; cv ~3 utts ~= 140 kB / 70 kB. The budget must beat
        # the AUTO-DTYPE rescue: at 300 kB decide_device_feed demotes to
        # bf16 tables which then FIT (no rotation). 150 kB forces K>=2
        # train shards even at bf16.
        monkeypatch.setenv("RSRGAN_FEED_HBM_BUDGET", "150000")
        rows = _run_train(data_dir, str(tmp_path / "exp_rot"), [
            "--batch_size=2", "--device_feed=on",
            "--min_epoches=1", "--max_epoches=2", "--steps_per_call=2"])
        # iteration == residency: K>=2 shards x 2 epochs at block=1
        assert len(rows) >= 4, f"rotation did not engage: {len(rows)} rows"
        assert all(np.isfinite(r["g_loss"]) for r in rows)

        rows_blk = _run_train(data_dir, str(tmp_path / "exp_blk"), [
            "--batch_size=2", "--device_feed=on",
            "--feed_rotation_block=2", "--min_epoches=1", "--max_epoches=2",
            "--steps_per_call=2"])
        # block=2, epochs=2 -> one residency per shard, K iterations
        assert len(rows_blk) >= 2
        assert all(np.isfinite(r["g_loss"]) for r in rows_blk)

    def test_rotation_lr_staircase(self, tmp_path, monkeypatch):
        """lr decay under rotation follows the reference staircase on
        COMPLETED corpus epochs (train_gan_rnn_placeholder.py:458-461,
        524-533): every residency inside epoch 1 trains at the init lr
        (a 1-epoch warm-up must not decay mid-epoch), and epoch 2 of a
        min_epoches=1 run trains at the final value (1e-4 x init)."""
        data_dir = _build_corpus(tmp_path)
        monkeypatch.setenv("RSRGAN_FEED_HBM_BUDGET", "150000")
        save = str(tmp_path / "exp_lr")
        _run_train(data_dir, save, [
            "--batch_size=2", "--device_feed=on",
            "--min_epoches=1", "--max_epoches=2", "--steps_per_call=2"])
        with open(os.path.join(save, "metrics_train.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        assert "eff_epoch" in rows[0], "rotation did not engage"
        # residencies are sub-epoch (K >= 2 shards at block=1)
        assert rows[0]["eff_epoch"] < 1.0, rows[0]
        assert rows[-1]["eff_epoch"] > 1.0, "never reached epoch 2"
        # lr used in residency i = staircase value of the epochs
        # COMPLETED before it started (min_iters=1 -> final = 1e-4 x init)
        prev_eff = 0.0
        for r in rows:
            want = 0.0005 if int(prev_eff) < 1 else 0.0005 * 1e-4
            assert r["g_lr"] == pytest.approx(want), (prev_eff, r)
            prev_eff = r["eff_epoch"]

    def test_dp_feed_equals_single_device_cli(self, tmp_path, monkeypatch):
        """--num_gpu=2 --batch_size=1 with the device feed must match
        --num_gpu=1 --batch_size=2 (same global batch, same plans).

        The CLI applies the reference's lr x num_gpu rule
        (make_hparams / exponential_decay multiply_jobs), so the DP run
        passes HALF the flag lr to land on the same effective rate."""
        # CPU devices report no memory statistics to size the tables by
        monkeypatch.setenv("RSRGAN_FEED_HBM_BUDGET", "1e9")
        data_dir = _build_corpus(tmp_path)
        rows_1 = _run_train(data_dir, str(tmp_path / "exp_1"), [
            "--batch_size=2", "--num_gpu=1", "--device_feed=on",
            "--g_learning_rate=0.0005",
            "--min_epoches=1", "--max_epoches=2", "--steps_per_call=2"])
        rows_dp = _run_train(data_dir, str(tmp_path / "exp_dp"), [
            "--batch_size=1", "--num_gpu=2", "--device_feed=on",
            "--g_learning_rate=0.00025",
            "--min_epoches=1", "--max_epoches=2", "--steps_per_call=2"])
        assert len(rows_1) == len(rows_dp) == 2
        for r1, rd in zip(rows_1, rows_dp):
            for k in ("g_mse_loss", "g_loss"):
                np.testing.assert_allclose(r1[k], rd[k], rtol=1e-5)
