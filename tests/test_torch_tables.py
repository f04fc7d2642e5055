"""The PyTorch port compiles the same tables as the JAX package.

For the parity rule set of tests/test_parity.py and for the 500-rule
CRS-style corpus, both packages compile the same rule sources; every
array of every table must be equal (dtype, shape and values — uint32
words compared through the port's int32-bit storage), and so must the
scan-plan records, the Stage-A prefilter metadata, the window-DFA map,
the field specs, the leaf bindings and the stats. `tables_from_reference`
must carry the JAX package's tables across unchanged.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pingoo_tpu.compiler.plan import compile_ruleset as ref_compile
from pingoo_tpu.config.schema import Action as RefAction
from pingoo_tpu.config.schema import RuleConfig as RefRuleConfig
from pingoo_tpu.expr import compile_expression as ref_compile_expression
from pingoo_tpu.utils.crs import generate_ruleset as ref_generate_ruleset
from pingoo_tpu_torch.compiler.plan import compile_ruleset, \
    tables_from_reference
from pingoo_tpu_torch.config.schema import Action, RuleConfig
from pingoo_tpu_torch.expr import Ip, compile_expression
from pingoo_tpu_torch.utils.crs import generate_ruleset
from test_parity import HOST_FALLBACK_SOURCES, LISTS, RULE_SOURCES

torch.set_num_threads(1)


def port_lists(lists):
    """The same lists with the port's own Ip values."""
    return {k: [Ip(str(v)) if hasattr(v, "contains") else v for v in vals]
            for k, vals in lists.items()}


def build_parity():
    sources = RULE_SOURCES + HOST_FALLBACK_SOURCES
    ref_rules = [RefRuleConfig(name=f"r{i}",
                               expression=ref_compile_expression(s),
                               actions=(RefAction.BLOCK,))
                 for i, s in enumerate(sources)]
    rules = [RuleConfig(name=f"r{i}", expression=compile_expression(s),
                        actions=(Action.BLOCK,))
             for i, s in enumerate(sources)]
    return (ref_compile(ref_rules, LISTS),
            compile_ruleset(rules, port_lists(LISTS), device="cpu"))


def build_crs500():
    ref_rules, ref_lists = ref_generate_ruleset(500)
    rules, lists = generate_ruleset(500)
    return (ref_compile(ref_rules, ref_lists),
            compile_ruleset(rules, lists, device="cpu"))


@pytest.fixture(scope="module", params=["parity", "crs500"])
def plans(request):
    return {"parity": build_parity, "crs500": build_crs500}[request.param]()


def ref_arrays(value, prefix=""):
    """A JAX-package table as {field: numpy array}, nested tables
    flattened as `parent.child` (the port's numpy_arrays layout)."""
    if isinstance(value, dict):
        return {f"{prefix}{k}": np.asarray(v) for k, v in value.items()}
    names = value._fields if hasattr(value, "_fields") else [
        f.name for f in dataclasses.fields(value)]
    out = {}
    for name in names:
        v = getattr(value, name)
        if v is None:
            continue
        if hasattr(v, "_fields") or dataclasses.is_dataclass(v):
            out.update(ref_arrays(v, f"{prefix}{name}."))
        elif hasattr(v, "shape"):
            out[f"{prefix}{name}"] = np.asarray(v)
    return out


def ref_meta(value):
    if isinstance(value, dict) or hasattr(value, "_fields"):
        return {}
    return {f.name: getattr(value, f.name) for f in dataclasses.fields(value)
            if not hasattr(getattr(value, f.name), "shape")}


def assert_same_arrays(key, want: dict, got: dict):
    assert set(want) == set(got), (key, set(want) ^ set(got))
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype, (key, name, g.dtype, w.dtype)
        assert g.shape == w.shape, (key, name, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{key}.{name}")


def test_table_keys_match(plans):
    ref, port = plans
    assert list(port.np_tables) == list(ref.np_tables)


def test_every_table_array_equal(plans):
    ref, port = plans
    for key, val in ref.np_tables.items():
        assert_same_arrays(key, ref_arrays(val),
                           port.np_tables[key].numpy_arrays())


def test_table_metadata_equal(plans):
    ref, port = plans
    for key, val in ref.np_tables.items():
        want = ref_meta(val)
        got = port.np_tables[key].meta()
        assert got == want, key


def test_tables_live_on_the_plan_device(plans):
    _, port = plans
    assert port.device == torch.device("cpu")
    for key, table in port.np_tables.items():
        assert table.device == torch.device("cpu"), key


def test_scan_plans_match(plans):
    ref, port = plans
    assert list(port.scan_plans) == list(ref.scan_plans)
    for key, want in ref.scan_plans.items():
        got = port.scan_plans[key]
        for f in dataclasses.fields(want):
            w, g = getattr(want, f.name), getattr(got, f.name)
            if dataclasses.is_dataclass(w):
                assert dataclasses.asdict(g) == dataclasses.asdict(w), \
                    (key, f.name)
            else:
                assert g == w, (key, f.name)


def test_prefilter_plan_matches(plans):
    ref, port = plans
    rp, pp = ref.prefilter, port.prefilter
    assert (rp is None) == (pp is None)
    if rp is None:
        return
    assert list(pp.fields) == list(rp.fields)
    for field, ff in rp.fields.items():
        got = pp.fields[field]
        assert (got.field, got.table_key, got.num_factors, got.factors) == \
            (ff.field, ff.table_key, ff.num_factors, ff.factors)
    assert pp.bank_field == rp.bank_field
    assert pp.bank_gated == rp.bank_gated
    assert pp.slot_codes == rp.slot_codes
    assert pp.default_mode == rp.default_mode
    assert list(pp.bank_masks) == list(rp.bank_masks)
    for key, mask in rp.bank_masks.items():
        np.testing.assert_array_equal(pp.bank_masks[key], mask)


def test_win_dfa_field_specs_and_modes_match(plans):
    ref, port = plans
    assert port.win_dfa == ref.win_dfa
    assert port.field_specs == ref.field_specs
    assert port.dfa_default_mode == ref.dfa_default_mode
    assert port.route_index == ref.route_index


def test_rules_bindings_and_stats_match(plans):
    ref, port = plans
    assert [(r.name, r.index, r.host, r.always) for r in port.rules] == \
        [(r.name, r.index, r.host, r.always) for r in ref.rules]
    assert len(port.leaves) == len(ref.leaves)
    assert list(port.bindings) == list(ref.bindings)
    for leaf_id, want in ref.bindings.items():
        got = port.bindings[leaf_id]
        assert (got.kind, got.field, got.group, got.col, tuple(got.span),
                got.table_key) == (want.kind, want.field, want.group,
                                   want.col, tuple(want.span),
                                   want.table_key), leaf_id
    for k, v in ref.stats.items():
        if k in port.stats:
            assert port.stats[k] == v, k
    assert set(port.stats) <= set(ref.stats)


def test_tables_from_reference_round_trip(plans):
    ref, port = plans
    carried = tables_from_reference(ref.np_tables, "cpu")
    assert list(carried) == list(port.np_tables)
    for key, table in carried.items():
        assert type(table) is type(port.np_tables[key]), key
        assert_same_arrays(key, port.np_tables[key].numpy_arrays(),
                           table.numpy_arrays())
        assert table.meta() == port.np_tables[key].meta(), key
