"""The port's file-backed token corpus (``kubeflow_tpu_torch.training.
dataset``) against the JAX package's (``kubeflow_tpu.training.dataset``):
the shards both writers make are byte-identical, and the two readers agree
token for token on every step, from any resume point, across an epoch
boundary, with and without the prefetch thread. Exact comparisons only:
both are numpy over the same files."""

import hashlib
import os

import numpy as np
import pytest
import torch

from kubeflow_tpu.training import dataset as j_ds
from kubeflow_tpu_torch.training import dataset as t_ds

SEQ = 32
BATCH = 4


def _docs(seed=0, n=3, length=350, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length, dtype=np.int32) for _ in range(n)]


@pytest.fixture
def corpus(tmp_path):
    d = str(tmp_path / "corpus")
    t_ds.write_token_shards(d, _docs(), shard_tokens=350, vocab_size=512)
    return d


@pytest.mark.parametrize("shard_tokens", [350, 200, 1 << 22])
def test_writers_make_identical_shards(tmp_path, shard_tokens):
    """Both writers over the same documents: the same shard files, byte
    for byte, and the same dataset.json (a shard size that splits
    documents, one that matches them, one larger than the corpus)."""
    docs = _docs(seed=1)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jpaths = j_ds.write_token_shards(jd, docs, shard_tokens=shard_tokens,
                                     vocab_size=512)
    tpaths = t_ds.write_token_shards(td, docs, shard_tokens=shard_tokens,
                                     vocab_size=512)
    assert [os.path.basename(p) for p in tpaths] == \
        [os.path.basename(p) for p in jpaths]
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    for name in os.listdir(jd):
        with open(os.path.join(jd, name), "rb") as a, \
                open(os.path.join(td, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_reader_matches_jax_token_for_token(corpus, seed, prefetch):
    """30 windows, batch 4: steps 0..15 cross the epoch boundary (step 7
    holds windows 28..31). Window ids, state and batches equal the JAX
    reader's from step 0 and from each resume point."""
    jr = j_ds.TokenDataset(corpus, SEQ, seed=seed)
    tr = t_ds.TokenDataset(corpus, SEQ, seed=seed)
    assert tr.n_windows == jr.n_windows == 30
    for step in range(16):
        np.testing.assert_array_equal(tr.window_ids_for_step(step, BATCH),
                                      jr.window_ids_for_step(step, BATCH))
        assert tr.state(step, BATCH) == jr.state(step, BATCH)
    for w in (0, 9, 10, 29):
        np.testing.assert_array_equal(tr.window(w), jr.window(w))
    for start in (0, 7, 13):
        ours = tr.batches(BATCH, start_step=start, prefetch=prefetch)
        theirs = jr.batches(BATCH, start_step=start, prefetch=0)
        for _ in range(9):
            a, b = next(ours), next(theirs)
            assert a.keys() == {"tokens"}
            assert a["tokens"].dtype == np.int32
            assert a["tokens"].shape == (BATCH, SEQ + 1)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
        ours.close()
        theirs.close()


def test_corpus_too_small_raises_as_the_reference(tmp_path):
    d = str(tmp_path / "tiny")
    t_ds.write_token_shards(d, [np.arange(10)], shard_tokens=10)
    with pytest.raises(ValueError, match="corpus too small") as ours:
        t_ds.TokenDataset(d, seq_len=SEQ)
    with pytest.raises(ValueError) as theirs:
        j_ds.TokenDataset(d, seq_len=SEQ)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(FileNotFoundError):
        t_ds.TokenDataset(str(tmp_path), seq_len=SEQ)


def test_batches_take_this_process_slice(corpus, monkeypatch):
    """Under a world of 2 (torch.distributed's rank and size), each
    process yields its contiguous half of the global batch; a global
    batch the world does not divide raises."""
    ds = t_ds.TokenDataset(corpus, SEQ, seed=3)
    whole = next(ds.batches(BATCH, start_step=5, prefetch=0))["tokens"]
    halves = []
    for rank in (0, 1):
        monkeypatch.setattr(t_ds, "_process_index_and_count",
                            lambda r=rank: (r, 2))
        halves.append(next(ds.batches(BATCH, start_step=5,
                                      prefetch=0))["tokens"])
    np.testing.assert_array_equal(np.concatenate(halves), whole)
    with pytest.raises(ValueError, match="not divisible"):
        next(ds.batches(3, prefetch=0))


def test_fit_over_the_corpus_resumes_the_exact_mapping(corpus, tmp_path):
    """The port's ``fit`` over a TokenDataset, stopped dead after its
    step-4 save and resumed from a fresh trainer: every batch either run
    consumed is the one the dataset maps to its step, and the two runs
    together cover steps 0..9 (past the 30-window epoch)."""
    import dataclasses

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.training import (
        Trainer, TrainerConfig, fit, lm_loss_fn,
    )

    cfg = dataclasses.replace(llama.llama_tiny(dtype=torch.float32),
                              vocab_size=512)
    ds = t_ds.TokenDataset(corpus, SEQ, seed=5)
    ckpt = str(tmp_path / "ckpt")
    seen: dict = {}

    def trainer():
        return Trainer(lambda g: llama.init_params(g, cfg, device="cpu"),
                       lm_loss_fn(llama.forward, cfg),
                       TrainerConfig(learning_rate=1e-3, warmup_steps=2,
                                     total_steps=100), device="cpu")

    def batches(start):
        for step, b in enumerate(ds.batches(BATCH, start_step=start),
                                 start):
            seen.setdefault(step, []).append(
                hashlib.sha1(b["tokens"].tobytes()).hexdigest())
            yield b

    class Killed(Exception):
        pass

    def kill(step, m):
        if step == 5:
            raise Killed

    with pytest.raises(Killed):
        fit(trainer(), batches, max_steps=10, checkpoint_dir=ckpt,
            checkpoint_every=4, on_step=kill)
    r = fit(trainer(), batches, max_steps=10, checkpoint_dir=ckpt,
            checkpoint_every=4)
    assert r.resumed_from == 4 and r.final_step == 10
    assert set(range(10)) <= set(seen)
    for step, shas in seen.items():
        want = hashlib.sha1(next(ds.batches(
            BATCH, start_step=step, prefetch=0))["tokens"].tobytes()
        ).hexdigest()
        assert set(shas) == {want}, f"step {step} diverged after resume"
    assert len(seen[4]) == 2            # step 4 replayed after the resume
