"""The port's data pipeline (``repro_torch.data.pipeline``) against the JAX
package's.

The reference's own suite (``tests/test_data.py``) carried over, then
parity: ``SyntheticLM`` batches bit-equal to the reference's over seeds,
hosts, steps, vocabularies and Zipf exponents; ``ShardedTokenFiles``
batches, ``state``/``restore`` and ``skip_shard`` equal on the same
shards; ``make_batch_iterator`` equal for both sources.  Every comparison
is exact (``array_equal``, dtypes equal): the pipeline is host numpy.
"""
import numpy as np
import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.data import pipeline as RP
from repro_torch.configs import SHAPES, get_config
from repro_torch.data.pipeline import (ShardedTokenFiles, SyntheticLM,
                                       make_batch_iterator)


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


# -- the reference's suite, on the port ----------------------------------------

def test_synthetic_deterministic():
    a = SyntheticLM(vocab=1000, seq_len=32, batch_per_host=4, seed=1)
    b = SyntheticLM(vocab=1000, seq_len=32, batch_per_host=4, seed=1)
    ba, bb = a.batch(17), b.batch(17)
    np.testing.assert_array_equal(ba["tokens"], bb["tokens"])
    # different steps/hosts/seeds differ
    assert not np.array_equal(ba["tokens"], a.batch(18)["tokens"])
    c = SyntheticLM(vocab=1000, seq_len=32, batch_per_host=4, seed=1,
                    host_id=1)
    assert not np.array_equal(ba["tokens"], c.batch(17)["tokens"])


def test_synthetic_labels_shifted():
    d = SyntheticLM(vocab=50, seq_len=16, batch_per_host=2, seed=0)
    b = d.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_synthetic_zipf_tail():
    d = SyntheticLM(vocab=10000, seq_len=256, batch_per_host=64, seed=3,
                    alpha=1.1)
    toks = d.batch(0)["tokens"].ravel()
    counts = np.bincount(toks, minlength=10000)
    top = np.sort(counts)[::-1]
    # heavy tail: top token much more frequent than median token
    assert top[0] > 20 * max(np.median(counts), 1)


def test_shard_files_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 60000, 10000).astype(np.uint16)
    ShardedTokenFiles.write_shards(str(tmp_path), tokens, n_shards=4)
    src = ShardedTokenFiles(str(tmp_path), seq_len=16, batch_per_host=2)
    b = src.batch()
    assert b["tokens"].shape == (2, 16)
    expect = tokens[:2 * 17].astype(np.int32).reshape(2, 17)
    np.testing.assert_array_equal(b["tokens"], expect[:, :-1])


def test_shard_state_restore(tmp_path):
    tokens = np.arange(5000, dtype=np.uint16)
    ShardedTokenFiles.write_shards(str(tmp_path), tokens, n_shards=2)
    src = ShardedTokenFiles(str(tmp_path), seq_len=8, batch_per_host=2)
    src.batch()
    st = src.state()
    b1 = src.batch()
    src2 = ShardedTokenFiles(str(tmp_path), seq_len=8, batch_per_host=2)
    src2.restore(st)
    b2 = src2.batch()
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])


def test_skip_shard_straggler_hook(tmp_path):
    tokens = np.arange(4000, dtype=np.uint16)
    ShardedTokenFiles.write_shards(str(tmp_path), tokens, n_shards=4)
    src = ShardedTokenFiles(str(tmp_path), seq_len=8, batch_per_host=1)
    first = src.batch()["tokens"][0, 0]
    src.skip_shard()
    after = src.batch()["tokens"][0, 0]
    assert after != first + 9  # jumped to the next shard, not sequential


# -- parity with the reference ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("host_id", [0, 3])
@pytest.mark.parametrize("vocab,alpha", [(256, 1.05), (256000, 1.05),
                                         (50, 1.3)])
def test_synthetic_bit_equal_to_reference(seed, host_id, vocab, alpha):
    kw = dict(vocab=vocab, seq_len=24, batch_per_host=3, seed=seed,
              alpha=alpha, host_id=host_id)
    port, ref = SyntheticLM(**kw), RP.SyntheticLM(**kw)
    np.testing.assert_array_equal(port._perm, ref._perm)
    for step in (0, 1, 7, 2 ** 31 + 5):
        _equal(port.batch(step), ref.batch(step))


def test_synthetic_iterator_equal_to_reference():
    kw = dict(vocab=1000, seq_len=8, batch_per_host=2, seed=4)
    for a, b, _ in zip(SyntheticLM(**kw), RP.SyntheticLM(**kw), range(5)):
        _equal(a, b)


def _shards(path, n_tokens, n_shards, seed=0):
    tokens = np.random.RandomState(seed).randint(
        0, 60000, n_tokens).astype(np.uint16)
    port = ShardedTokenFiles.write_shards(str(path / "p"), tokens, n_shards)
    ref = RP.ShardedTokenFiles.write_shards(str(path / "r"), tokens,
                                            n_shards)
    return port, ref


def test_write_shards_equal_to_reference(tmp_path):
    port, ref = _shards(tmp_path, 9999, 5)
    assert [p.split("/")[-1] for p in port] == [r.split("/")[-1] for r in ref]
    for p, r in zip(port, ref):
        with open(p, "rb") as a, open(r, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (3, 1), (3, 2),
                                             (8, 5)])
def test_shard_batches_state_and_skip_equal_to_reference(tmp_path, n_hosts,
                                                         host_id):
    _shards(tmp_path, 7000, 6)
    kw = dict(seq_len=15, batch_per_host=3, host_id=host_id,
              n_hosts=n_hosts)
    port = ShardedTokenFiles(str(tmp_path / "p"), **kw)
    ref = RP.ShardedTokenFiles(str(tmp_path / "r"), **kw)
    for i in range(12):
        _equal(port.batch(), ref.batch())
        assert port.state() == ref.state()
        if i % 4 == 3:
            port.skip_shard()
            ref.skip_shard()
    st = ref.state()
    port2 = ShardedTokenFiles(str(tmp_path / "p"), **kw)
    port2.restore(st)
    ref.restore(st)
    _equal(port2.batch(), ref.batch())


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_make_batch_iterator_equal_to_reference(tmp_path, shape):
    cfg, rcfg = get_config("gemma2-2b"), ref_get_config("gemma2-2b")
    shp, rshp = SHAPES[shape], REF_SHAPES[shape]
    port = make_batch_iterator(cfg, shp, seed=3, host_id=1, n_hosts=64)
    ref = RP.make_batch_iterator(rcfg, rshp, seed=3, host_id=1, n_hosts=64)
    for _ in range(2):
        _equal(next(port), next(ref))
    _shards(tmp_path, 200_000, 4)
    port = make_batch_iterator(cfg, shp, shard_dir=str(tmp_path / "p"),
                               host_id=0, n_hosts=64)
    ref = RP.make_batch_iterator(rcfg, rshp, shard_dir=str(tmp_path / "r"),
                                 host_id=0, n_hosts=64)
    _equal(next(port), next(ref))
