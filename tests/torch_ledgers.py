"""Where the port's tests keep the durable cost ledger: never at the
repo root.

PINGOO_COST_LEDGER is on by default in both packages, with the file
`COST_LEDGER.json` in the working directory, which at the repo root is
a tracked file of the JAX package. A test module that starts a
`VerdictService`, a `RingSidecar`, a `Server` or `python -m
pingoo_tpu_torch` imports these autouse fixtures:

    from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

Each test gets a ledger file of its own under its `tmp_path` (named
otherwise than the default, so that a test can tell the two apart), so
no test reloads another's costs; services that a module-scoped fixture
starts use one file per module. Children inherit the variable through
the environment. A module whose own autouse fixture deletes the
variable sets it again there.
"""

import pytest


@pytest.fixture(autouse=True, scope="module")
def cost_ledger_per_module(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PINGOO_COST_LEDGER",
                  str(tmp_path_factory.mktemp("ledgers") / "cost_ledger.json"))
        yield


@pytest.fixture(autouse=True)
def cost_ledger_per_test(monkeypatch, tmp_path):
    path = tmp_path / "cost_ledger.json"
    monkeypatch.setenv("PINGOO_COST_LEDGER", str(path))
    return path
