"""The port's synthetic LM data (``repro_torch.data.lm_synthetic``).

``jax.random`` streams cannot be reproduced, so the port's draws are held
to the reference's law: shapes and dtypes, every chain a permutation,
client i on chain i % groups, labels the tokens shifted by one, and the
share of steps that follow the chain, 1 − ε + ε / V, within the same
binomial band as the reference's own draws.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import lm_synthetic as ref_lm
from repro_torch.data import lm_synthetic


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_chains_are_permutations_on_the_generators_device():
    chains = lm_synthetic.make_group_chains(_gen(), 3, 50)
    assert tuple(chains.shape) == (3, 50) and chains.dtype == torch.int64
    assert chains.device == _gen().device
    for c in chains:
        assert torch.equal(torch.sort(c).values, torch.arange(50))
    assert not torch.equal(chains[0], chains[1])
    again = lm_synthetic.make_group_chains(_gen(), 3, 50)
    assert torch.equal(chains, again)  # the same seed, the same chains


@pytest.mark.parametrize("m,groups", [(4, 2), (5, 3), (3, 1)])
def test_federated_batch_shapes_and_client_chains(m, groups):
    gen = _gen(1)
    vocab, batch, seq = 40, 6, 30
    chains = lm_synthetic.make_group_chains(gen, groups, vocab)
    b = lm_synthetic.federated_lm_batch(gen, chains, m, batch, seq, noise=0.0)
    assert tuple(b["tokens"].shape) == tuple(b["labels"].shape) == (m, batch, seq)
    assert b["tokens"].dtype == b["labels"].dtype == torch.int64
    assert torch.equal(b["tokens"][:, :, 1:], b["labels"][:, :, :-1])
    for i in range(m):  # noiseless: every step follows client i's chain
        chain = chains[i % groups]
        assert torch.equal(chain[b["tokens"][i]], b["labels"][i])
        if groups > 1:
            other = chains[(i + 1) % groups]
            assert not torch.equal(other[b["tokens"][i]], b["labels"][i])


def test_chain_law_matches_the_reference():
    vocab, batch, seq, noise = 32, 64, 64, 0.2
    ref_chain = np.asarray(ref_lm.make_group_chains(jax.random.PRNGKey(0), 1, vocab))[0]
    ref_seq = np.asarray(jax.jit(lambda k: ref_lm.sample_sequences(
        k, jax.numpy.asarray(ref_chain), batch, seq, noise=noise))(jax.random.PRNGKey(1)))
    chain = torch.tensor(ref_chain, dtype=torch.int64)  # the reference's chain, injected
    got = lm_synthetic.sample_sequences(_gen(2), chain, batch, seq, noise=noise)
    assert tuple(got.shape) == ref_seq.shape == (batch, seq)
    assert int(got.min()) >= 0 and int(got.max()) < vocab
    expect = 1 - noise + noise / vocab
    n_steps = batch * (seq - 1)
    band = 4 * np.sqrt(expect * (1 - expect) / n_steps)
    ref_follow = float(np.mean(ref_chain[ref_seq[:, :-1]] == ref_seq[:, 1:]))
    follow = float((chain[got[:, :-1]] == got[:, 1:]).float().mean())
    assert abs(ref_follow - expect) < band and abs(follow - expect) < band
