"""The port's token pipeline (`repro_torch.data.pipeline`) against the
reference's (`repro.data.pipeline`): the same numpy code, so every batch's
tokens and labels are bit-equal (int32 tensors here), host-sharded or not;
plus the reference's own data tests (`tests/test_substrate.py`) on the
port."""
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCfg as RShape
from repro.data import pipeline as RD
from repro_torch.configs.base import ShapeCfg
from repro_torch.data import pipeline as PD


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in got:
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.fixture
def text_file(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(bytes(np.random.default_rng(5).integers(
        0, 256, 4096, dtype=np.uint8)))
    return str(path)


@pytest.mark.parametrize("hosts", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("kind", ["synthetic", "file"])
def test_batches_equal_the_reference(kind, hosts, text_file):
    host_id, n_hosts = hosts
    kw = dict(seed=3, vocab_size=1000, kind=kind,
              path=text_file if kind == "file" else None)
    ref = RD.make_source(RD.DataConfig(**kw))
    port = PD.make_source(PD.DataConfig(**kw))
    assert type(port).__name__ == type(ref).__name__
    for step in (0, 7):
        _equal(port.batch(step, 8, 24, host_id, n_hosts, device="cpu"),
               ref.batch(step, 8, 24, host_id, n_hosts))


def test_batches_iterator_equals_the_reference():
    kw = dict(seed=1, vocab_size=300)
    ref = RD.batches(RD.SyntheticLM(RD.DataConfig(**kw)),
                     RShape("t", 16, 4, "train"), start_step=5)
    port = PD.batches(PD.SyntheticLM(PD.DataConfig(**kw)),
                      ShapeCfg("t", 16, 4, "train"), start_step=5,
                      device="cpu")
    for _ in range(3):
        (rs, rb), (ps, pb) = next(ref), next(port)
        assert rs == ps
        _equal(pb, rb)


def test_uneven_host_split_raises():
    src = PD.SyntheticLM(PD.DataConfig(vocab_size=50))
    with pytest.raises(ValueError, match="hosts"):
        src.batch(0, 6, 8, host_id=0, n_hosts=4, device="cpu")


# ------------------------------------------ the reference's own tests
def test_data_deterministic_and_host_sharded():
    src = PD.SyntheticLM(PD.DataConfig(seed=3, vocab_size=101))
    b1 = src.batch(step=7, batch=8, seq=16, device="cpu")
    b2 = src.batch(step=7, batch=8, seq=16, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    # host slices partition the global batch deterministically
    h0 = src.batch(step=7, batch=8, seq=16, host_id=0, n_hosts=2,
                   device="cpu")
    h1 = src.batch(step=7, batch=8, seq=16, host_id=1, n_hosts=2,
                   device="cpu")
    assert h0["tokens"].shape == (4, 16)
    assert not torch.equal(h0["tokens"], h1["tokens"])


def test_data_labels_are_shifted_tokens():
    src = PD.SyntheticLM(PD.DataConfig(seed=0, vocab_size=64))
    b = src.batch(0, 4, 32, device="cpu")
    assert b["tokens"].shape == b["labels"].shape == (4, 32)
    assert int(b["tokens"].max()) < 64
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_has_learnable_structure():
    """Bigram following rate is induced (loss can go below unigram)."""
    src = PD.SyntheticLM(PD.DataConfig(seed=0, vocab_size=64))
    toks = src.batch(0, 64, 64, device="cpu")["tokens"].numpy()
    nxt = src._perm[toks[:, :-1] % 64]
    follow = (toks[:, 1:] == nxt).mean()
    assert follow > 0.3
