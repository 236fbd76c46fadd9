"""Shared checks of the port's production benches against the reference's
(``tests/test_torch_bench_*.py``)."""

# grouping-summary fields that both packages compute alike (the budget's
# key is named for each package's cost model: vmem_budget / plan_budget)
GROUPING_FIELDS = ("num_pairs", "launches_per_layer", "launches_grouped",
                   "fused_groups", "gather_groups", "fused_pairs",
                   "fallbacks")


def same_grouping(port: dict, ref: dict) -> None:
    for field in GROUPING_FIELDS:
        assert port[field] == ref[field], field
    assert port["segments"] == ref["segments"]
    assert port["plan_budget"] == ref["vmem_budget"]
