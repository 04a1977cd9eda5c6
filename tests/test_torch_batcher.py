"""PyTorch port: ``ContinuousBatcher`` against sequential serving and the
reference's batcher, on the CPU, and the port's examples at reduced
size.

The port's twin of ``tests/test_serving.py``'s
``test_continuous_batcher_matches_sequential`` (reduced granite-8b,
prompts of 5, 7 and 6 tokens, 2 slots): the port's batcher gives the
port's sequential tokens and the reference batcher's tokens, on the
reference's weights carried through ``convert.from_numpy_tree``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_reduced as t_reduced  # noqa: E402
from repro_torch.examples import quickstart, serve_continuous  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import from_numpy_tree  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request  # noqa: E402
from repro_torch.serving.batcher import splice_batch_axis  # noqa: E402

N_SLOTS, CACHE_LEN, NEW = 2, 48, 4


@pytest.fixture(scope="module")
def weights():
    """The reference's reduced granite-8b parameters, as numpy."""
    params = JM.init_params(j_reduced("granite-8b"), jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(2)
    vocab = j_reduced("granite-8b").vocab
    return [rng.integers(0, vocab, (L,)) for L in (5, 7, 6)]


def _torch_fns(cfg, params):
    def prefill_fn(tokens):
        logits, caches, _ = TM.prefill(cfg, params, tokens,
                                       cache_len=CACHE_LEN)
        return logits.argmax(-1).to(torch.int32), caches

    def decode_fn(tok, pos, caches):
        logits, caches = TM.decode_step(cfg, params, tok, pos, caches)
        return logits.argmax(-1).to(torch.int32)[:, None], caches

    return prefill_fn, decode_fn


def _run(batcher_cls, request_cls, prefill_fn, decode_fn, caches, prompts):
    batcher = batcher_cls(prefill_fn, decode_fn, caches, n_slots=N_SLOTS)
    for i, p in enumerate(prompts):
        batcher.submit(request_cls(rid=i, tokens=p, max_new_tokens=NEW))
    stats = batcher.run_until_drained()
    assert stats["finished"] == len(prompts)
    return {r.rid: r.out_tokens for r in batcher.finished}, stats


def test_continuous_batcher_matches_sequential(weights, prompts):
    """Batched continuous decoding gives the tokens of serving each
    request alone, and the reference batcher's tokens."""
    cfg = t_reduced("granite-8b")
    params = from_numpy_tree(weights, "cpu")
    prefill_fn, decode_fn = _torch_fns(cfg, params)

    sequential = []
    for p in prompts:
        first, caches = prefill_fn(torch.as_tensor(p[None],
                                                   dtype=torch.int32))
        toks, cur = [int(first[0])], first[:, None]
        for i in range(NEW - 1):
            pos = torch.full((1,), len(p) + i, dtype=torch.int32)
            cur, caches = decode_fn(cur, pos, caches)
            toks.append(int(cur[0, 0]))
        sequential.append(toks)

    got, stats = _run(ContinuousBatcher, Request, prefill_fn, decode_fn,
                      TM.init_cache(cfg, N_SLOTS, CACHE_LEN, "cpu"),
                      prompts)
    for i, ref in enumerate(sequential):
        assert got[i] == ref, f"request {i}: {got[i]} != {ref}"

    jcfg = j_reduced("granite-8b")
    jparams = jax.tree.map(jnp.asarray, weights)

    def j_prefill(tokens):
        logits, caches, _ = JM.prefill(jcfg, jparams, tokens,
                                       cache_len=CACHE_LEN)
        return jnp.argmax(logits, -1).astype(jnp.int32), caches

    @jax.jit
    def j_decode(tok, pos, caches):
        logits, caches = JM.decode_step(jcfg, jparams, tok, pos, caches)
        return jnp.argmax(logits, -1).astype(jnp.int32)[:, None], caches

    want, jstats = _run(JBatcher, JRequest, j_prefill, j_decode,
                        JM.init_cache(jcfg, N_SLOTS, CACHE_LEN), prompts)
    assert got == want
    assert stats["steps"] == jstats["steps"]


def test_splice_writes_one_slot_in_place():
    """The splice writes batch entry ``slot`` of every stacked leaf from
    a batch-1 tree, leaves the other entries as they were, and keeps
    every leaf's address."""
    cfg = t_reduced("recurrentgemma-2b")
    full = TM.init_cache(cfg, 3, 20, "cpu")
    fresh = dict(TM._leaves(TM.init_cache(cfg, 3, 20, "cpu")))
    gen = torch.Generator().manual_seed(0)
    one = TM.init_cache(cfg, 1, 20, "cpu")
    for _, leaf in TM._leaves(one):
        leaf.copy_(torch.randn(leaf.shape, generator=gen) * 100)
    ptrs = {name: leaf.data_ptr() for name, leaf in TM._leaves(full)}
    assert splice_batch_axis(full, one, 1) is full
    ones = dict(TM._leaves(one))
    for name, leaf in TM._leaves(full):
        assert leaf.data_ptr() == ptrs[name]
        assert torch.equal(leaf[:, 1], ones[name][:, 0].to(leaf.dtype))
        for other in (0, 2):
            assert torch.equal(leaf[:, other], fresh[name][:, other]), name


@pytest.mark.parametrize("example", ["serve_continuous", "quickstart"])
def test_example_runs_on_cpu(example, capsys):
    """The port's examples at reduced size with ``--device cpu``."""
    if example == "serve_continuous":
        stats = serve_continuous.main(["--device", "cpu"])
        assert stats["finished"] == 10
        assert "OK" in capsys.readouterr().out
    else:
        out, policy = quickstart.level_b("cpu")
        assert out.shape == (1, 4)
        assert "weights.core" in policy.prewarm
