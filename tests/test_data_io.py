"""Data-layer tests: ark codec, CMVN, splicing, store, batchers."""

import os
import struct

import numpy as np
import pytest

from rsrgan_jax.data import (ArkWriter, Cmvn, CmvnAccumulator, FrameBatcher,
                             ScpReader, SequenceBatcher, StoreWriter,
                             UtteranceStore, build_store_from_scp,
                             cmvn_from_stats, convert_cmvn_to_numpy,
                             infer_batches, iter_ark, load_cmvn_npz,
                             read_ark_matrix, splice_frames, splice_frames_np,
                             write_kaldi_cmvn)
from rsrgan_jax.data.kaldi_ark import _decode_compressed


def _write_ark_set(tmp_path, rng, n=5, dim=7, name="feats"):
    scp = str(tmp_path / f"{name}.scp")
    ark = str(tmp_path / f"{name}.ark")
    mats = {}
    writer = ArkWriter(scp)
    for i in range(n):
        mat = rng.normal(size=(10 + i * 3, dim)).astype(np.float32)
        utt = f"utt{i:03d}"
        writer.write_next_utt(ark, utt, mat)
        mats[utt] = mat
    writer.close()
    return scp, ark, mats


class TestArkCodec:
    def test_roundtrip_via_scp(self, tmp_path, rng):
        scp, ark, mats = _write_ark_set(tmp_path, rng)
        reader = ScpReader(scp)
        assert reader.utt_ids == sorted(mats.keys())
        for utt, mat in mats.items():
            np.testing.assert_array_equal(reader.read_utt(utt), mat)

    def test_roundtrip_sequential(self, tmp_path, rng):
        _, ark, mats = _write_ark_set(tmp_path, rng)
        seen = dict(iter_ark(ark))
        assert seen.keys() == mats.keys()
        for utt in mats:
            np.testing.assert_array_equal(seen[utt], mats[utt])

    def test_double_matrix(self, tmp_path, rng):
        """Reader accepts \\0BDM (double) payloads like kaldi_io.py:114-116."""
        ark = str(tmp_path / "d.ark")
        mat = rng.normal(size=(4, 3))
        with open(ark, "wb") as f:
            f.write(b"u1 " + b"\0BDM ")
            f.write(struct.pack("<bi", 4, 4))
            f.write(struct.pack("<bi", 4, 3))
            f.write(mat.astype("<f8").tobytes())
        got = read_ark_matrix(ark, 3)
        np.testing.assert_allclose(got, mat)

    def test_compressed_matrix_matches_reference_algorithm(self, rng):
        """Vectorized BCM decode == the reference's per-element dequantizer."""
        rows, cols = 23, 5
        min_value, value_range = -4.0, 8.0
        headers = np.sort(
            rng.integers(0, 65536, size=(cols, 4)), axis=1).astype("<u2")
        data = rng.integers(0, 256, size=(cols, rows)).astype(np.uint8)
        payload = headers.tobytes() + data.tobytes()

        got = _decode_compressed(payload, min_value, value_range, rows, cols)

        # straight port of kaldi_io.py:121-161 (per-element)
        def u16f(v):
            return min_value + value_range * 1.52590218966964e-05 * v

        expect = np.zeros((rows, cols))
        for c in range(cols):
            p0, p25, p75, p100 = (u16f(float(headers[c, k])) for k in range(4))
            for r in range(rows):
                v = int(data[c, r])
                if v < 64:
                    expect[r, c] = p0 + (p25 - p0) * v / 64.0
                elif v <= 192:
                    expect[r, c] = p25 + (p75 - p25) * (v - 64) / 128.0
                else:
                    expect[r, c] = p75 + (p100 - p75) * (v - 192) / 63.0
        # the decoder computes in float64 then returns float32 (the dtype
        # every read path shares) — expected must be cast the same way
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, expect.astype(np.float32))

    def test_compressed_end_to_end(self, tmp_path, rng):
        rows, cols = 17, 4
        headers = np.sort(
            rng.integers(0, 65536, size=(cols, 4)), axis=1).astype("<u2")
        data = rng.integers(0, 256, size=(cols, rows)).astype(np.uint8)
        ark = str(tmp_path / "c.ark")
        with open(ark, "wb") as f:
            f.write(b"utt1 ")
            pos = f.tell()
            f.write(b"\0BCM ")
            f.write(struct.pack("<ffii", -1.0, 2.0, rows, cols))
            f.write(headers.tobytes())
            f.write(data.tobytes())
        mat = read_ark_matrix(ark, pos)
        assert mat.shape == (rows, cols)

    def test_compressed_write_roundtrip(self, tmp_path, rng):
        """ArkWriter(compress=True) emits BCM our reader decodes accurately."""
        mats = {
            "gauss": rng.normal(scale=3.0, size=(120, 13)),
            "tiny": rng.normal(size=(1, 4)),          # single-row corner case
            "constant": np.full((9, 5), 2.5),         # zero dynamic range
            "outliers": np.concatenate(
                [rng.normal(size=(200, 6)),
                 rng.normal(scale=50.0, size=(3, 6))]),
        }
        scp = str(tmp_path / "c.scp")
        ark = str(tmp_path / "c.ark")
        with ArkWriter(scp, compress=True) as w:
            for utt, m in mats.items():
                w.write_next_utt(ark, utt, m)
        reader = ScpReader(scp)
        for utt, m in mats.items():
            with open(ark, "rb") as f:
                f.seek(dict((u, o) for u, p, o in reader.entries)[utt])
                # Kaldi's automatic method: <= 8 rows -> format 2
                expect = b"\0BCM2" if m.shape[0] <= 8 else b"\0BCM "
                assert f.read(5) == expect
            got = reader.read_utt(utt)
            assert got.shape == m.shape
            # percentile quantization: inner 25-75 band has ~1/128 of the
            # band width resolution; bound overall error loosely by range/64
            span = float(m.max() - m.min())
            tol = max(span / 64.0, 1e-4)
            assert np.max(np.abs(got - m.astype(np.float32))) <= tol
            # bulk of the data should be much tighter than the loose bound
            med_err = np.median(np.abs(got - m))
            assert med_err <= max(span / 500.0, 1e-5)

    def test_cm2_cm3_read_hand_built(self, tmp_path):
        """Formats 2/3 from stock Kaldi (<= 8 rows): hand-built bytes ->
        exact dequantization. The reference REJECTS these
        (io_funcs/kaldi_io.py:104-107)."""
        import struct

        rows, cols = 3, 4
        min_value, value_range = -2.0, 8.0
        codes16 = np.arange(rows * cols, dtype="<u2") * 5000
        codes8 = (np.arange(rows * cols, dtype=np.uint8) * 20)
        ark = str(tmp_path / "cm23.ark")
        with open(ark, "wb") as f:
            pos2 = f.tell()
            f.write(b"\0BCM2 ")
            f.write(struct.pack("<ffii", min_value, value_range, rows, cols))
            f.write(codes16.tobytes())
            pos3 = f.tell()
            f.write(b"\0BCM3 ")
            f.write(struct.pack("<ffii", min_value, value_range, rows, cols))
            f.write(codes8.tobytes())
        m2 = read_ark_matrix(ark, pos2)
        expect2 = (min_value + value_range
                   * codes16.astype(np.float64) / 65535.0).reshape(rows, cols)
        assert m2.dtype == np.float32
        np.testing.assert_array_equal(m2, expect2.astype(np.float32))
        m3 = read_ark_matrix(ark, pos3)
        expect3 = (min_value + value_range
                   * codes8.astype(np.float64) / 255.0).reshape(rows, cols)
        assert m3.dtype == np.float32
        np.testing.assert_array_equal(m3, expect3.astype(np.float32))

    def test_cm2_write_read_roundtrip_accuracy(self, rng):
        """CM2 is a uniform 16-bit quantizer: error <= range/65535."""
        import io

        from rsrgan_jax.data.kaldi_ark import read_matrix, write_matrix

        m = rng.normal(scale=5.0, size=(6, 11)).astype(np.float32)
        buf = io.BytesIO()
        write_matrix(buf, m, compress=True)
        buf.seek(0)
        got = read_matrix(buf)
        assert got.shape == m.shape
        step = (float(m.max()) - float(m.min())) / 65535.0
        assert np.max(np.abs(got - m)) <= step

    def test_text_ark_roundtrip(self, tmp_path, rng):
        """ArkWriter(text=True) emits copy-feats ark,t:-style archives
        readable via scp offsets AND sequentially; float32 exact."""
        from rsrgan_jax.data.kaldi_ark import iter_ark

        mats = {"a": rng.normal(scale=3.0, size=(5, 4)).astype(np.float32),
                "b": rng.normal(size=(1, 7)).astype(np.float32),
                "c": np.array([[1e-20, -2.5e8, 0.0]], np.float32)}
        scp = str(tmp_path / "t.scp")
        ark = str(tmp_path / "t.ark")
        with ArkWriter(scp, text=True) as w:
            for utt, m in mats.items():
                w.write_next_utt(ark, utt, m)
        reader = ScpReader(scp)
        for utt, m in mats.items():
            np.testing.assert_array_equal(reader.read_utt(utt), m)
        seq = dict(iter_ark(ark))
        assert seq.keys() == mats.keys()
        for utt, m in mats.items():
            np.testing.assert_array_equal(seq[utt], m)

    def test_text_ark_hand_written_kaldi_style(self, tmp_path):
        """Exact Kaldi copy-feats ark,t: layout parses correctly."""
        ark = tmp_path / "k.ark"
        ark.write_bytes(b"utt1  [\n  1.5 -2 3.25 \n  4 5 6 ]\n"
                        b"utt2  [\n  7 8 ]\n")
        from rsrgan_jax.data.kaldi_ark import iter_ark

        got = dict(iter_ark(str(ark)))
        np.testing.assert_array_equal(
            got["utt1"], np.array([[1.5, -2, 3.25], [4, 5, 6]], np.float32))
        np.testing.assert_array_equal(got["utt2"],
                                      np.array([[7, 8]], np.float32))

    def test_text_compress_conflict(self, tmp_path):
        with pytest.raises(ValueError, match="cannot be compressed"):
            ArkWriter(str(tmp_path / "x.scp"), compress=True, text=True)

    def test_compressed_write_rejects_bad_input(self, tmp_path):
        from rsrgan_jax.data.kaldi_ark import _encode_compressed
        with np.testing.assert_raises(ValueError):
            _encode_compressed(np.array([[1.0, np.inf]]))
        with np.testing.assert_raises(ValueError):
            _encode_compressed(np.zeros((0, 3)))


class TestCmvn:
    def test_accumulator_matches_direct(self, rng):
        feats = rng.normal(loc=2.0, scale=3.0, size=(100, 6))
        acc = CmvnAccumulator(6)
        acc.accumulate(feats[:40])
        acc.accumulate(feats[40:])
        cmvn = acc.finalize()
        np.testing.assert_allclose(cmvn.mean, feats.mean(axis=0), rtol=1e-10)
        np.testing.assert_allclose(cmvn.stddev, feats.std(axis=0), rtol=1e-6)

    def test_apply_denormalize_roundtrip(self, rng):
        feats = rng.normal(size=(30, 4))
        cmvn = Cmvn(mean=feats.mean(0), stddev=feats.std(0))
        np.testing.assert_allclose(
            cmvn.denormalize(cmvn.apply(feats)), feats, atol=1e-12)

    def test_convert_cmvn_to_numpy(self, tmp_path, rng):
        """Kaldi binary stats file -> train_cmvn.npz, per reference layout."""
        paths = {}
        truth = {}
        for name, dim in (("inputs", 5), ("labels", 3)):
            feats = rng.normal(size=(57, dim))
            acc = CmvnAccumulator(dim)
            acc.accumulate(feats)
            path = str(tmp_path / f"{name}.cmvn")
            write_kaldi_cmvn(path, acc.stats_matrix())
            paths[name] = path
            truth[name] = feats
        out = convert_cmvn_to_numpy(paths["inputs"], paths["labels"],
                                    str(tmp_path))
        cin, clab = load_cmvn_npz(out)
        np.testing.assert_allclose(cin.mean, truth["inputs"].mean(0),
                                   rtol=1e-4)
        np.testing.assert_allclose(clab.stddev, truth["labels"].std(0),
                                   rtol=1e-3)


class TestSplice:
    def _reference_splice(self, feats, left, right):
        """Port of tfrecords_dataset.py:80-105 (slice + SYMMETRIC pads)."""
        T = feats.shape[0]
        parts = []
        for i in range(left, 0, -1):
            fl = feats[:T - i]
            for _ in range(i):
                fl = np.concatenate([fl[:1], fl], axis=0)
            parts.append(fl)
        parts.append(feats)
        for i in range(1, right + 1):
            fr = feats[i:]
            for _ in range(i):
                fr = np.concatenate([fr, fr[-1:]], axis=0)
            parts.append(fr)
        return np.concatenate(parts, axis=1)

    @pytest.mark.parametrize("left,right", [(0, 0), (1, 1), (3, 2), (5, 5)])
    def test_matches_reference(self, rng, left, right):
        feats = rng.normal(size=(12, 4)).astype(np.float32)
        expect = self._reference_splice(feats, left, right)
        np.testing.assert_array_equal(
            splice_frames_np(feats, left, right), expect)
        np.testing.assert_allclose(
            np.asarray(splice_frames(feats, left, right)), expect, atol=1e-6)


class TestStore:
    def test_rejects_frame_misaligned_pair(self, tmp_path, rng):
        """Different input/label frame counts (e.g. a wet file keeping the
        reverb tail) must fail at store build with the utt named, not as
        a broadcast error in the batcher."""
        with StoreWriter(str(tmp_path / "bad.rtu")) as w:
            with pytest.raises(ValueError, match="u0.*503 frames.*500"):
                w.add("u0", rng.normal(size=(503, 5)).astype(np.float32),
                      rng.normal(size=(500, 2)).astype(np.float32))
            w.add("u1", rng.normal(size=(10, 5)).astype(np.float32),
                  rng.normal(size=(10, 2)).astype(np.float32))

    def test_store_roundtrip(self, tmp_path, rng):
        path = str(tmp_path / "shard.rtu")
        utts = {f"u{i}": (rng.normal(size=(8 + i, 5)).astype(np.float32),
                          rng.normal(size=(8 + i, 2)).astype(np.float32))
                for i in range(4)}
        with StoreWriter(path) as w:
            for utt, (x, y) in utts.items():
                w.add(utt, x, y)
        store = UtteranceStore([path])
        assert len(store) == 4 and store.has_labels
        assert store.input_dim == 5 and store.output_dim == 2
        for i, (utt, (x, y)) in enumerate(utts.items()):
            uid, xi, yi = store[i]
            assert uid == utt
            np.testing.assert_array_equal(xi, x)
            np.testing.assert_array_equal(yi, y)
        np.testing.assert_array_equal(store.lengths, [8, 9, 10, 11])

    def test_build_from_scp_applies_cmvn(self, tmp_path, rng):
        in_scp, _, in_mats = _write_ark_set(tmp_path, rng, dim=5, name="in")
        lab_scp, _, lab_mats = _write_ark_set(tmp_path, rng, dim=3, name="lab")
        cmvn_in = Cmvn(np.full(5, 2.0), np.full(5, 4.0))
        out = str(tmp_path / "s.rtu")
        n = build_store_from_scp(in_scp, out, lab_scp, cmvn_in, None)
        assert n == len(in_mats)
        store = UtteranceStore(out)
        uid, x, y = store[0]
        np.testing.assert_allclose(x, (in_mats[uid] - 2.0) / 4.0, rtol=1e-5)
        np.testing.assert_allclose(y, lab_mats[uid], rtol=1e-6)


def _make_store(tmp_path, rng, lengths, in_dim=6, out_dim=2):
    path = str(tmp_path / "ds.rtu")
    with StoreWriter(path) as w:
        for i, t in enumerate(lengths):
            w.add(f"u{i}", rng.normal(size=(t, in_dim)).astype(np.float32),
                  rng.normal(size=(t, out_dim)).astype(np.float32))
    return UtteranceStore(path)


class TestBatchers:
    def test_sequence_batcher_static_shapes(self, tmp_path, rng):
        lengths = [180, 190, 210, 230, 260, 270, 410, 420]
        store = _make_store(tmp_path, rng, lengths)
        batcher = SequenceBatcher(store, batch_size=2, shuffle=False)
        batches = list(batcher)
        assert len(batches) == batcher.num_batches() == 4
        for b in batches:
            assert b.inputs.shape[0] == 2
            # padded length is a static bucket edge
            assert (b.inputs.shape[1] - 200) % 50 == 0
            assert b.inputs.shape[1] >= b.lengths.max()
            assert b.labels.shape[:2] == b.inputs.shape[:2]
            for row, ln in enumerate(b.lengths):
                assert np.all(b.inputs[row, ln:] == 0)

    def test_batcher_names_utt_on_legacy_misaligned_labels(self, tmp_path,
                                                           rng):
        """Stores written before StoreWriter rejected frame-misaligned
        pairs must fail in the batcher with the utt named, not with an
        opaque numpy broadcast error."""
        store = _make_store(tmp_path, rng, [200, 200])
        orig = store.labels
        store.labels = lambda i: orig(i)[:-3]
        batcher = SequenceBatcher(store, batch_size=2, shuffle=False)
        with pytest.raises(ValueError, match="u0.*200 frames.*197"):
            next(iter(batcher))

    def test_sequence_batcher_drops_ragged(self, tmp_path, rng):
        lengths = [210, 215, 220]  # same bucket, batch 2 -> one batch
        store = _make_store(tmp_path, rng, lengths)
        batcher = SequenceBatcher(store, batch_size=2, shuffle=False)
        assert batcher.num_batches() == 1
        assert len(list(batcher)) == 1
        keep = SequenceBatcher(store, batch_size=2, shuffle=False,
                               drop_remainder=False)
        assert keep.num_batches() == 2
        assert len(list(keep)) == 2

    def test_sequence_batcher_splice(self, tmp_path, rng):
        store = _make_store(tmp_path, rng, [100, 100])
        batcher = SequenceBatcher(store, batch_size=2, left_context=2,
                                  right_context=1, shuffle=False)
        (batch,) = list(batcher)
        assert batch.inputs.shape[2] == 6 * 4
        expect = splice_frames_np(np.asarray(store.inputs(0)), 2, 1)
        np.testing.assert_array_equal(batch.inputs[0, :100], expect)

    def test_frame_batcher(self, tmp_path, rng):
        store = _make_store(tmp_path, rng, [30, 20, 25])
        fb = FrameBatcher(store, batch_size=16, shuffle=True, seed=1)
        assert fb.num_frames == 75
        assert fb.num_batches() == 4
        batches = list(fb)
        assert len(batches) == 4
        assert all(x.shape == (16, 6) and y.shape == (16, 2)
                   for x, y in batches)

    def test_infer_batches(self, tmp_path, rng):
        store = _make_store(tmp_path, rng, [100, 300])
        items = list(infer_batches(store, pad_to_multiple=128))
        assert items[0].inputs.shape == (1, 128, 6)
        assert items[1].inputs.shape == (1, 384, 6)
        assert items[0].lengths[0] == 100


class TestPrefetcherErrors:
    def test_producer_exception_propagates(self):
        from rsrgan_jax.data import ThreadedPrefetcher

        def bad_iter():
            yield 1
            raise OSError("disk vanished")

        it = iter(ThreadedPrefetcher(bad_iter(), 4))
        assert next(it) == 1
        with pytest.raises(RuntimeError, match="prefetch producer failed"):
            list(it)


class TestHostShardedBatches:
    def test_sequence_blocks_recombine_to_global_batch(self, tmp_path, rng):
        from rsrgan_jax.data import (HostShardedSequenceBatches,
                                     SequenceBatcher, StoreWriter,
                                     UtteranceStore)
        store_path = str(tmp_path / "s.rtu")
        w = StoreWriter(store_path)
        for i in range(17):
            t = int(rng.integers(20, 90))
            w.add(f"u{i}", rng.normal(size=(t, 5)).astype(np.float32),
                  rng.normal(size=(t, 3)).astype(np.float32))
        w.close()
        store = UtteranceStore(store_path)

        def batcher():
            return SequenceBatcher(store, 4, shuffle=True, seed=3,
                                   drop_remainder=False)

        globals_ = [b for b in batcher() if len(b.utt_ids) == 4]
        shards = [list(HostShardedSequenceBatches(batcher(), p, 2))
                  for p in range(2)]
        assert len(shards[0]) == len(shards[1]) == len(globals_)
        for g, b0, b1 in zip(globals_, shards[0], shards[1]):
            # identical shapes across hosts (multi-host dispatch invariant)
            assert b0.inputs.shape == b1.inputs.shape
            assert b0.inputs.shape[1] == g.inputs.shape[1]
            # concatenated host blocks == the single-host global batch
            assert b0.utt_ids + b1.utt_ids == g.utt_ids
            np.testing.assert_array_equal(
                np.concatenate([b0.inputs, b1.inputs]), g.inputs)
            np.testing.assert_array_equal(
                np.concatenate([b0.labels, b1.labels]), g.labels)
            np.testing.assert_array_equal(
                np.concatenate([b0.lengths, b1.lengths]), g.lengths)

    def test_frame_blocks_recombine(self, tmp_path, rng):
        from rsrgan_jax.data import (FrameBatcher, HostShardedFrameBatches,
                                     StoreWriter, UtteranceStore)
        store_path = str(tmp_path / "f.rtu")
        w = StoreWriter(store_path)
        for i in range(5):
            t = int(rng.integers(10, 30))
            w.add(f"u{i}", rng.normal(size=(t, 4)).astype(np.float32),
                  rng.normal(size=(t, 2)).astype(np.float32))
        w.close()
        store = UtteranceStore(store_path)

        def batcher():
            return FrameBatcher(store, 8, seed=5)

        globals_ = list(batcher())
        shards = [list(HostShardedFrameBatches(batcher(), p, 2))
                  for p in range(2)]
        assert len(shards[0]) == len(globals_)
        for (gx, gy), (x0, y0), (x1, y1) in zip(globals_, *shards):
            np.testing.assert_array_equal(np.concatenate([x0, x1]), gx)
            np.testing.assert_array_equal(np.concatenate([y0, y1]), gy)

    def test_indivisible_batch_rejected(self, tmp_path, rng):
        from rsrgan_jax.data import (HostShardedSequenceBatches,
                                     SequenceBatcher, StoreWriter,
                                     UtteranceStore)
        store_path = str(tmp_path / "o.rtu")
        w = StoreWriter(store_path)
        w.add("u0", np.zeros((30, 2), np.float32),
              np.zeros((30, 2), np.float32))
        w.close()
        b = SequenceBatcher(UtteranceStore(store_path), 3)
        with np.testing.assert_raises(ValueError):
            HostShardedSequenceBatches(b, 0, 2)
