"""Parity of the port's model-mesh rules (`repro_torch.sharding.axes`)
and logical-axes trees (`Model.param_axes`, `Model.cache_axes`) with
`repro`'s, in one process (no ranks: the mesh sizes come from stand-in
meshes, which both packages' `divisible_spec` read as `axis_names` and
`devices.shape`).  Everything here is exact: rule dicts, axes trees and
specs compare equal, the port's `P` as the tuple of `repro`'s
`PartitionSpec`.  The ranks themselves are `tests/test_torch_dp_train.py`'s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_smoke_config as r_smoke  # noqa: E402
from repro.models.api import build_model as r_build  # noqa: E402
from repro.sharding import axes as r_ax  # noqa: E402
from repro_torch.checkpoint.checkpointer import tree_flatten  # noqa: E402
from repro_torch.configs.base import PORTED, get_smoke_config  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.sharding import axes as ax  # noqa: E402

NAMES = ("pod", "data", "model")
SHAPES = ((2, 2, 2), (1, 2, 2), (4, 1, 1))


class StandIn:
    """A mesh as both packages' `divisible_spec` read it."""

    def __init__(self, shape, names=NAMES):
        self.axis_names = names
        self.devices = np.empty(shape)


def rule_sets(mp):
    """Name → (the port's rules, repro's rules), every rule function."""
    return {
        "base": (ax.base_rules(mp), r_ax.base_rules(mp)),
        "fsdp": (ax.fsdp_rules(ax.base_rules(mp), mp),
                 r_ax.fsdp_rules(r_ax.base_rules(mp), mp)),
        "pure_dp": (ax.pure_dp_rules(mp), r_ax.pure_dp_rules(mp)),
        "sequence_parallel": (ax.sequence_parallel_rules(mp),
                              r_ax.sequence_parallel_rules(mp)),
        "opt": (ax.opt_rules(ax.base_rules(mp), mp),
                r_ax.opt_rules(r_ax.base_rules(mp), mp)),
        "opt_pure_dp": (ax.opt_rules(ax.pure_dp_rules(mp), mp),
                        r_ax.opt_rules(r_ax.pure_dp_rules(mp), mp)),
        "opt_overrides": (ax.opt_overrides(mp), r_ax.opt_overrides(mp)),
    }


@pytest.mark.parametrize("mp", [False, True])
@pytest.mark.parametrize("name", ["base", "fsdp", "pure_dp",
                                  "sequence_parallel", "opt", "opt_pure_dp",
                                  "opt_overrides"])
def test_rule_dicts_equal_repro(name, mp):
    got, want = rule_sets(mp)[name]
    assert got == want
    assert list(got) == list(want)           # and in the same order


def test_spec_for_dedups_axes():
    """`tests/test_sharding.py`'s cases, both packages."""
    rules = ax.base_rules(multi_pod=True)
    spec = ax.spec_for(("batch", "heads"), rules)
    assert spec == ax.P(("pod", "data"), "model")
    assert tuple(spec) == tuple(r_ax.spec_for(("batch", "heads"),
                                              r_ax.base_rules(True)))
    assert ax.spec_for(("batch",)) == ax.P() == ()     # no rules active


def test_divisible_spec_drops_nondivisible():
    mesh = StandIn((2, 2, 2))
    cases = [(("model",), (3,)), ((("pod", "data"),), (2,)),
             (("model", None, "data"), (4, 5, 6))]
    want = [(), ("pod",), ("model", None, "data")]
    for (entries, shape), w in zip(cases, want):
        got = ax.divisible_spec(ax.P(*entries), shape, mesh)
        assert tuple(got) == w
        assert tuple(got) == tuple(r_ax.divisible_spec(
            r_ax.P(*entries), shape, mesh))


def test_fsdp_and_opt_rules():
    r = ax.base_rules(True)
    assert ax.fsdp_rules(r, True)["embed"] == ("pod", "data")
    assert ax.opt_rules(r, False)["embed"] == ("data",)


def test_p_is_the_tuple_of_a_partition_spec():
    assert ax.P() == () and ax.P(None, "data") == (None, "data")
    assert tuple(r_ax.P(("pod", "data"), None, "model")) == \
        ax.P(("pod", "data"), None, "model")
    assert repr(ax.P("model")) == "P('model',)"


def as_tuples(tree):
    """A tree of axes tuples as nested plain tuples and dicts (the two
    packages' namedtuple classes differ)."""
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not ax._is_axes_leaf(tree):
        return tuple(as_tuples(v) for v in tree)
    return tree


def axes_leaves(tree, prefix=""):
    """(path, axes) of every leaf, in the order `map_axes` walks."""
    out = []
    ax.map_axes(lambda a, p: out.append((p, a)), tree, paths(tree, prefix))
    return out


def paths(tree, prefix):
    if ax._is_axes_leaf(tree):
        return prefix
    if isinstance(tree, dict):
        return {k: paths(v, f"{prefix}/{k}") for k, v in tree.items()}
    vals = [paths(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


@pytest.fixture(scope="module")
def trees():
    """arch → (port's param axes, cache axes, leaf shapes by path;
    repro's param axes, cache axes)."""
    out = {}
    for arch in PORTED:
        model = build_model(get_smoke_config(arch), "cpu")
        rm = r_build(r_smoke(arch))
        caches = model.init_caches(2, 16)
        c_axes = model.cache_axes()
        shapes = {}
        ax.map_axes(lambda a, p, t: shapes.__setitem__(p, tuple(t.shape)),
                    c_axes, paths(c_axes, "cache"), caches)
        ax.map_axes(lambda a, p, d: shapes.__setitem__(p, d.shape),
                    model.param_axes(), paths(model.param_axes(), "param"),
                    model.spec)
        out[arch] = (model.param_axes(), c_axes, shapes, rm.param_axes(),
                     rm.cache_axes())
    return out


def as_specs(tree):
    """A tree of specs (dicts of `P`) as dicts of plain tuples."""
    if isinstance(tree, dict):
        return {k: as_specs(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("arch", PORTED)
def test_axes_trees_equal_repro(trees, arch):
    p_axes, c_axes, _, rp_axes, rc_axes = trees[arch]
    assert as_tuples(p_axes) == as_tuples(rp_axes)
    assert as_tuples(c_axes) == as_tuples(rc_axes)
    assert type(c_axes).__name__ == type(rc_axes).__name__
    for mp in (False, True):
        for name, (rules, r_rules) in rule_sets(mp).items():
            assert as_specs(ax.tree_specs(p_axes, rules)) == \
                as_specs(r_ax.tree_specs(rp_axes, r_rules)), name


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", PORTED)
def test_spec_for_and_divisible_spec_on_every_leaf(trees, arch, shape):
    """Every leaf of the parameter and cache axes, every rule set of both
    multi-pod settings, on the mesh shape: `spec_for` and `divisible_spec`
    (with the leaf's shape) equal repro's."""
    p_axes, c_axes, shapes, _, _ = trees[arch]
    mesh = StandIn(shape)
    leaves = axes_leaves(p_axes, "param") + axes_leaves(c_axes, "cache")
    n = 0
    for mp in (False, True):
        for name, (rules, r_rules) in rule_sets(mp).items():
            for path, axes in leaves:
                got = ax.spec_for(axes, rules)
                want = r_ax.spec_for(axes, r_rules)
                assert tuple(got) == tuple(want), (name, path)
                got = ax.divisible_spec(got, shapes[path], mesh)
                want = r_ax.divisible_spec(want, shapes[path], mesh)
                assert tuple(got) == tuple(want), (name, path, shape)
                n += 1
    assert n == 2 * 7 * len(leaves)


class FakeMesh:
    """The part of a `DeviceMesh` that `NamedSharding` reads, at a given
    coordinate."""

    def __init__(self, shape, coord, names=NAMES):
        self.mesh_dim_names, self.shape, self.coord = names, shape, coord

    def get_coordinate(self):
        return self.coord


def test_named_sharding_blocks_are_major_first():
    """("pod", "data") on dimension 1 of [3, 8] over a (2, 2, 2) mesh: the
    block index is pod·2 + data, each of 2 columns; "model" replicates."""
    from torch.distributed.tensor import Replicate, Shard
    spec = ax.P(None, ("pod", "data"))
    for pod in (0, 1):
        for data in (0, 1):
            for model in (0, 1):
                s = ax.NamedSharding(FakeMesh((2, 2, 2), [pod, data, model]),
                                     spec)
                k = pod * 2 + data
                assert s.block((3, 8)) == (slice(None), slice(2 * k,
                                                              2 * k + 2))
    assert s.placements == (Shard(1), Shard(1), Replicate())
    assert ax.NamedSharding(FakeMesh((2, 2, 2), None), spec).block(
        (3, 8)) is None
    with pytest.raises(ValueError, match="mesh order"):
        ax.NamedSharding(FakeMesh((2, 2, 2), [0, 0, 0]),
                         ax.P(("data", "pod"))).placements


def test_tree_shardings_matched_drop_what_does_not_divide():
    """ZeRO-1 over a data axis of 3, which divides no smoke `embed`
    dimension of 64 but does divide others: each leaf's spec is repro's
    `divisible_spec` of its `spec_for`."""
    model = build_model(get_smoke_config("qwen3-1.7b"), "cpu")
    rules = ax.opt_rules(ax.pure_dp_rules(False))
    r_rules = r_ax.opt_rules(r_ax.pure_dp_rules(False))
    sh = ax.tree_shardings_matched(model.param_axes(), model.spec,
                                   FakeMesh((1, 3, 1), [0, 1, 0]), rules)
    seen = []

    def check(axes, s, d):
        want = r_ax.divisible_spec(r_ax.spec_for(axes, r_rules), d.shape,
                                   StandIn((1, 3, 1)))
        assert tuple(s.spec) == tuple(want)
        seen.append(tuple(s.spec))
    ax.map_axes(check, model.param_axes(), sh, model.spec)
    assert len(seen) == len(tree_flatten(model.spec)[0])


def test_check_data_parallel_refuses_what_it_would_replicate():
    """`check_ported` (the data-parallel check until tensor parallelism
    and FSDP were ported) passes those layouts, the SSM mixers on the
    residual's wide axis, `decode_32k`'s layout and
    `sequence_parallel_rules` on a mesh whose "data" axis is 1 or wider
    (the mixers on a second wide axis); it refuses the sequence on a
    wide mesh axis, naming the next slices, and model-parallel axes on a
    wide batch axis or on a second wide axis other than the mixers'."""
    dp = StandIn((1, 4, 1))
    dense = ("batch", "seq", "seq_kv", "act_embed", "embed", "heads",
             "kv_heads", "mlp", "vocab")
    decode_32k = dict(ax.base_rules(False), seq_kv="model", kv_heads=None)
    ax.check_ported(ax.pure_dp_rules(False), dp)
    ax.check_ported(ax.base_rules(True), StandIn((2, 2, 1)))
    ax.check_ported(ax.base_rules(False), StandIn((1, 2, 2)), dense)
    ax.check_ported(ax.fsdp_rules(ax.base_rules(False), False), dp)
    ax.check_ported(ax.base_rules(False), StandIn((1, 2, 2)),
                    ("batch", "ssm_heads"))
    ax.check_ported(ax.base_rules(False), StandIn((1, 2, 2)))
    ax.check_ported(decode_32k, StandIn((1, 2, 2)))
    ax.check_ported(ax.sequence_parallel_rules(False), StandIn((1, 1, 2)))
    ax.check_ported(ax.sequence_parallel_rules(False), dp)
    ax.check_ported(ax.sequence_parallel_rules(False), StandIn((1, 2, 2)),
                    ("batch", "ssm_heads"))
    assert ax.model_axis(ax.base_rules(False), StandIn((1, 2, 2))) == \
        "model"
    assert ax.model_axis(ax.pure_dp_rules(False), dp) is None
    assert ax.mixer_axis(ax.sequence_parallel_rules(False),
                         StandIn((1, 2, 2))) == "data"
    assert ax.mixer_axis(ax.base_rules(False), StandIn((1, 2, 2))) is None
    for rules, mesh, logical in (
            (dict(ax.sequence_parallel_rules(False), batch="data"),
             StandIn((1, 2, 2)), None),
            (dict(ax.sequence_parallel_rules(False), mlp="data"),
             StandIn((1, 2, 2)), ("mlp",)),
            (dict(ax.sequence_parallel_rules(False), ssm_heads="pod",
                  ssm_inner="pod"), StandIn((2, 2, 2)), None)):
        with pytest.raises(NotImplementedError):
            ax.check_ported(rules, mesh, logical)
    with pytest.raises(NotImplementedError, match="item 11b") as exc:
        ax.check_ported(ax.pure_dp_rules(True), StandIn((2, 2, 1)))
    assert ax.NEXT_SLICE in str(exc.value)


def test_shard_is_the_identity_or_refuses():
    x = torch.ones(2, 3, 4)
    assert ax.shard(x, "batch", "seq", "act_embed") is x     # no rules
    with ax.use_rules(ax.pure_dp_rules(False), StandIn((1, 4, 1))):
        assert ax.shard(x, "batch", "seq", "act_embed") is x
        assert ax.get_rules() == ax.pure_dp_rules(False)
    assert ax.get_rules() is None and ax.get_mesh() is None
    with ax.use_rules(ax.sequence_parallel_rules(False), StandIn((1, 2, 2))):
        assert ax.shard(x, "batch", "seq", "embed") is x
        assert ax.shard(x, "batch", "seq_kv", "heads") is x
    with ax.use_rules(ax.pure_dp_rules(True), StandIn((2, 2, 1))):
        assert ax.shard(x, "batch", "seq_kv", "act_embed") is x
        with pytest.raises(NotImplementedError):
            ax.shard(x, "batch", "seq", "act_embed")
