"""Small sizes for ``test_bench_card.py``'s runs of every cell on the card.
Its table ``SMALL`` holds the systems the benchmark had when the test was
written; a system added since gives its own small size as ``SMALL`` in its
module (``systems/<name>.py``), which this hook adds to that table, so a
new cell needs no edit of the test."""
from bench import harness


def pytest_collection_modifyitems(items):
    for module in {getattr(item, "module", None) for item in items}:
        table = getattr(module, "SMALL", None)
        if module is None or module.__name__.rsplit(".", 1)[-1] != "test_bench_card" \
                or not isinstance(table, dict):
            continue
        for cfg in harness.benchmark()["configs"]:
            system = harness.load_json(harness.ROOT / cfg["file"])["system"]
            small = getattr(harness.system_module({"system": system}), "SMALL", None)
            if system not in table and small is not None:
                table[system] = dict(small)
