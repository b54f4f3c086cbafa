"""The port's shard-list handling (``multimodal_tpu_torch.data.shards``) against the JAX
package's: brace expansion, multi-source lists with weights, and the shard scheduler over
hosts, workers, epochs and resampled weighted draws, exact."""

import pytest

from multimodal_tpu.data import shards as jax_shards
from multimodal_tpu_torch.data import shards

PATTERNS = ["s-{000..002}.tar", "{a,b}/{0..1}", "plain.tar", "x{7..12}y{q,r}.tar",
            "d/{00..11}.tar", "{only}.tar", "a{,b}c"]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_braceexpand_matches_jax(pattern):
    assert shards.braceexpand(pattern) == jax_shards.braceexpand(pattern)


@pytest.mark.parametrize("urls,weights", [
    ("a-{0..1}.tar::b-{0..2}.tar", "1.0::2.0"),
    ("a-{0..1}.tar::b-{0..2}.tar", None),
    ("one-{000..004}.tar", "3"),
    (["x.tar", "y.tar"], [0.5, 1.5]),
    (["x.tar", "y.tar"], None),
])
def test_expand_shards_matches_jax(urls, weights):
    assert shards.expand_shards(urls, weights) == jax_shards.expand_shards(urls, weights)


def test_expand_shards_weight_count_error():
    for mod in (shards, jax_shards):
        with pytest.raises(ValueError, match="weights"):
            mod.expand_shards("a.tar::b.tar", "1.0")


@pytest.mark.parametrize("resampled", [False, True])
@pytest.mark.parametrize("hosts,workers", [(1, 1), (2, 1), (1, 3), (2, 2)])
def test_shard_sampler_matches_jax(resampled, hosts, workers):
    names = [f"s{i:03d}" for i in range(17)]
    weights = [1.0 + (i % 3) for i in range(17)] if resampled else None
    for epoch in (0, 1, 5):
        for host in range(hosts):
            for worker in range(workers):
                kw = dict(weights=weights, seed=11, resampled=resampled, num_hosts=hosts,
                          host_id=host, num_workers=workers, worker_id=worker)
                got = shards.ShardSampler(names, **kw)
                want = jax_shards.ShardSampler(names, **kw)
                got.set_epoch(epoch)
                want.set_epoch(epoch)
                assert list(got) == list(want)


def test_zero_weight_shards_are_never_drawn_like_jax():
    kw = dict(weights=[1.0] * 5 + [0.0] * 5, seed=3, resampled=True)
    got = list(shards.ShardSampler(["a"] * 5 + ["b"] * 5, **kw))
    assert got == list(jax_shards.ShardSampler(["a"] * 5 + ["b"] * 5, **kw))
    assert set(got) == {"a"}
