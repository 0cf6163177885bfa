"""Compat/parity extras: TFRecords interop (vs real TF writer), RT60 store,
split-scp, verify-store."""

import os

import numpy as np
import pytest

from rsrgan_jax.cli import prepare as prepare_cli
from rsrgan_jax.data import ArkWriter, StoreWriter, UtteranceStore
from rsrgan_jax.data.store import build_store_from_scp, verify_store
from rsrgan_jax.data.tfrecords_compat import (convert_tfrecords_to_store,
                                              iter_tfrecord_payloads,
                                              parse_sequence_example)

tf = pytest.importorskip("tensorflow")


def _write_reference_tfrecord(path, utts):
    """Serialize exactly like io_funcs/tfrecords_io.py:12-44."""
    with tf.io.TFRecordWriter(path) as writer:
        for utt_id, inputs, labels in utts:
            context = tf.train.Features(feature={
                "utt_id": tf.train.Feature(
                    bytes_list=tf.train.BytesList(
                        value=[utt_id.encode()]))})
            feature_list = {
                "inputs": tf.train.FeatureList(feature=[
                    tf.train.Feature(float_list=tf.train.FloatList(
                        value=row)) for row in inputs])}
            if labels is not None:
                feature_list["labels"] = tf.train.FeatureList(feature=[
                    tf.train.Feature(float_list=tf.train.FloatList(
                        value=row)) for row in labels])
            ex = tf.train.SequenceExample(
                context=context,
                feature_lists=tf.train.FeatureLists(
                    feature_list=feature_list))
            writer.write(ex.SerializeToString())


class TestTfrecordsCompat:
    def test_parse_reference_sequence_examples(self, tmp_path, rng):
        utts = [(f"utt{i}",
                 rng.normal(size=(7 + i, 5)).astype(np.float32),
                 rng.normal(size=(7 + i, 3)).astype(np.float32))
                for i in range(3)]
        path = str(tmp_path / "ref.tfrecords")
        _write_reference_tfrecord(path, utts)

        payloads = list(iter_tfrecord_payloads(path))
        assert len(payloads) == 3
        for (utt_id, x, y), payload in zip(utts, payloads):
            uid, xi, yi = parse_sequence_example(payload)
            assert uid == utt_id
            np.testing.assert_allclose(xi, x, rtol=1e-6)
            np.testing.assert_allclose(yi, y, rtol=1e-6)

    def test_convert_to_store(self, tmp_path, rng):
        utts = [(f"u{i}", rng.normal(size=(6, 4)).astype(np.float32), None)
                for i in range(2)]
        path = str(tmp_path / "test.tfrecords")
        _write_reference_tfrecord(path, utts)
        out = str(tmp_path / "conv.rtu")
        n = convert_tfrecords_to_store([path], out)
        assert n == 2
        store = UtteranceStore(out)
        assert not store.has_labels
        np.testing.assert_allclose(store.inputs(1), utts[1][1], rtol=1e-6)

    def test_cli_from_tfrecords(self, tmp_path, rng):
        utts = [("a", rng.normal(size=(5, 3)).astype(np.float32),
                 rng.normal(size=(5, 2)).astype(np.float32))]
        path = str(tmp_path / "cli.tfrecords")
        _write_reference_tfrecord(path, utts)
        rc = prepare_cli.main(["from-tfrecords", f"--tfrecords={path}",
                               f"--output_dir={tmp_path}", "--name=cli"])
        assert rc == 0
        assert len(UtteranceStore(str(tmp_path / "cli.rtu"))) == 1


class TestRt60Store:
    def test_rt60_column_prepended(self, tmp_path, rng):
        scp = str(tmp_path / "in.scp")
        ark = str(tmp_path / "in.ark")
        w = ArkWriter(scp)
        mats = {}
        for i in range(3):
            m = rng.normal(size=(10, 4)).astype(np.float32)
            w.write_next_utt(ark, f"u{i}", m)
            mats[f"u{i}"] = m
        w.close()
        rt60_scp = str(tmp_path / "rt60.scp")
        with open(rt60_scp, "w") as f:
            for i in range(3):
                f.write(f"u{i} 0.{i + 3}\n")
        out = str(tmp_path / "rta.rtu")
        build_store_from_scp(scp, out, rt60_scp=rt60_scp)
        store = UtteranceStore(out)
        assert store.input_dim == 5
        x = store.inputs(1)
        np.testing.assert_allclose(x[:, 0], 0.4, rtol=1e-6)
        np.testing.assert_allclose(x[:, 1:], mats["u1"], rtol=1e-6)


class TestPrepareExtras:
    def test_split_scp(self, tmp_path):
        data_dir = str(tmp_path)
        with open(os.path.join(data_dir, "inputs.scp"), "w") as f:
            f.writelines(f"u{i} /a.ark:{i}\n" for i in range(10))
        with open(os.path.join(data_dir, "labels.scp"), "w") as f:
            f.writelines(f"u{i} /b.ark:{i}\n" for i in range(10))
        assert prepare_cli.main(["split-scp", "--nj=3",
                                 f"--data_dir={data_dir}"]) == 0
        total = 0
        for j in range(1, 4):
            with open(os.path.join(data_dir, "split3",
                                   f"inputs{j}.scp")) as f:
                in_lines = f.readlines()
            with open(os.path.join(data_dir, "split3",
                                   f"labels{j}.scp")) as f:
                lab_lines = f.readlines()
            assert len(in_lines) == len(lab_lines)
            for a, b in zip(in_lines, lab_lines):
                assert a.split()[0] == b.split()[0]
            total += len(in_lines)
        assert total == 10

    def test_verify_store(self, tmp_path, rng):
        path = str(tmp_path / "v.rtu")
        with StoreWriter(path) as w:
            w.add("u0", rng.normal(size=(5, 3)).astype(np.float32))
        n, bad = verify_store(path)
        assert (n, bad) == (1, 0)
        assert prepare_cli.main(["verify-store", path]) == 0
        # truncated file fails
        raw = open(path, "rb").read()
        trunc = str(tmp_path / "t.rtu")
        open(trunc, "wb").write(raw[: len(raw) // 2])
        assert prepare_cli.main(["verify-store", trunc]) == 1
