"""The paper's Figure 3 counts: the port against the JAX package, run for
run.

`benchmarks/fig3_rejections.py` runs four algorithms (dpmeans, ofl,
bpmeans, dpmeans_separable) over Pb in {16, 64, 256} and N in {256, 1024,
2560}.  `tests/golden/torch_fig3_counts.json` holds its grid and, for
repeats 0-2 of every cell, each run's settings (entry point, data function
and seed, λ, k_max, OFL's key) beside the JAX package's proposed and
accepted totals.  `chip_smoke.py --phases fig3` reads the grid and the
settings from the file and holds the port on the card to its counts (the
card machine has no JAX).  The tests here check the grid and the settings
against the benchmark itself, regenerate the N = 256 cells from the JAX
package and require the file to match them, then run the port on the CPU
over the same cells and require it to match the file too.

Regenerate the golden (the JAX package on the CPU, about half a minute):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fig3.py
"""
import inspect
import json
import re
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

GOLDEN = Path(__file__).resolve().parent / "golden" / "torch_fig3_counts.json"
ALGOS = ("dpmeans", "ofl", "bpmeans", "dpmeans_separable")
PBS = (16, 64, 256)
NS = (256, 1024, 2560)
REPEATS = (0, 1, 2)
LAM = 4.0
ENTRY = {"dpmeans": "occ_dp_means", "dpmeans_separable": "occ_dp_means",
         "ofl": "occ_ofl", "bpmeans": "occ_bp_means"}


def cell_key(algo: str, pb: int, n: int) -> str:
    return f"{algo}/pb{pb}/n{n}"


def _settings(algo: str, n: int, r: int) -> dict:
    """One run of `benchmarks/fig3_rejections.run`, as the golden records
    it: entry point, data function and seed, λ, k_max and (OFL) the raw
    key data (0, r) of `jax.random.key(r)`."""
    data = {"dpmeans_separable": "separable_cluster_data",
            "bpmeans": "bp_stick_breaking_data"}.get(
                algo, "dp_stick_breaking_data")
    lam = 1.0 if algo == "dpmeans_separable" else LAM
    k_max = max(512 if algo == "ofl" else 256, n)
    return {"entry": ENTRY[algo], "data": data, "seed": 1000 + r,
            "lam": lam, "k_max": k_max,
            "key": [0, r] if algo == "ofl" else None}


def run_jax(s: dict, pb: int, n: int) -> tuple[int, int]:
    """(proposed, accepted) totals of one run in the JAX package."""
    import jax
    import jax.numpy as jnp
    from repro import core, data
    x = jnp.asarray(getattr(data, s["data"])(n, seed=s["seed"])[0])
    kw = ({"key": jax.random.key(s["key"][1])} if s["key"] is not None
          else {"max_iters": 1})
    res = getattr(core, s["entry"])(x, s["lam"], pb=pb, k_max=s["k_max"],
                                    **kw)
    return int(res.stats.proposed.sum()), int(res.stats.accepted.sum())


def run_port(s: dict, pb: int, n: int, device="cpu") -> tuple[int, int]:
    """The same run in the port; OFL's key is the raw key data."""
    from repro_torch import core, data
    x = getattr(data, s["data"])(n, seed=s["seed"])[0]
    kw = ({"key": tuple(s["key"])} if s["key"] is not None
          else {"max_iters": 1})
    res = getattr(core, s["entry"])(x, s["lam"], pb=pb, k_max=s["k_max"],
                                    device=device, **kw)
    return int(res.stats.proposed.sum()), int(res.stats.accepted.sum())


def _golden():
    return json.loads(GOLDEN.read_text())


CELLS_256 = [(a, pb, 256) for a in ALGOS for pb in PBS]


def test_golden_covers_every_cell():
    """The golden's grid is the benchmark's (its defaults, and the
    algorithms its loop walks), and its settings reproduce the benchmark's
    own runs: `run` at N = 256, Pb = 16, one repeat gives each algorithm's
    rejections of repeat 0."""
    from benchmarks import fig3_rejections as bench
    g = _golden()
    defaults = {k: p.default for k, p in
                inspect.signature(bench.run).parameters.items()}
    rows = bench.run(repeats=1, ns=(256,), pbs=(16,), quiet=True)
    algos = [name[len("fig3_"):-len("_pb16_n256")] for name, _, _ in rows]
    assert g["grid"] == {"algos": algos, "pbs": list(defaults["pbs"]),
                         "ns": list(defaults["ns"])}
    assert g["benchmark_repeats"] == defaults["repeats"]
    assert g["repeats"] == list(REPEATS)
    assert sorted(g["runs"]) == sorted(
        cell_key(a, pb, n) for a in algos for pb in defaults["pbs"]
        for n in defaults["ns"])
    for (name, _, derived), algo in zip(rows, algos):
        cell = g["runs"][cell_key(algo, 16, 256)]
        rej = float(re.search(r"rejections=([-\d.]+)", derived).group(1))
        assert rej == cell["proposed"][0] - cell["accepted"][0], name
    for key, cell in g["runs"].items():
        algo, pb, n = key.split("/")
        assert len(cell["proposed"]) == len(cell["accepted"]) \
            == len(cell["settings"]) == len(REPEATS)
        assert all(p >= a >= 1 for p, a in zip(cell["proposed"],
                                               cell["accepted"]))
        assert cell["settings"] == [_settings(algo, int(n[1:]), r)
                                    for r in REPEATS]
        assert cell["settings"][0]["lam"] == (
            1.0 if algo == "dpmeans_separable" else defaults["lam"])


@pytest.mark.parametrize("algo,pb,n", CELLS_256)
def test_golden_equals_the_jax_package(algo, pb, n):
    cell = _golden()["runs"][cell_key(algo, pb, n)]
    got = [run_jax(s, pb, n) for s in cell["settings"]]
    assert [p for p, _ in got] == cell["proposed"]
    assert [a for _, a in got] == cell["accepted"]


@pytest.mark.parametrize("algo,pb,n", CELLS_256)
def test_port_equals_the_golden(algo, pb, n):
    cell = _golden()["runs"][cell_key(algo, pb, n)]
    got = [run_port(s, pb, n) for s in cell["settings"]]
    assert [p for p, _ in got] == cell["proposed"]
    assert [a for _, a in got] == cell["accepted"]


def main() -> None:
    import jax
    t0 = time.perf_counter()
    runs = {}
    for algo in ALGOS:
        for pb in PBS:
            for n in NS:
                settings = [_settings(algo, n, r) for r in REPEATS]
                got = [run_jax(s, pb, n) for s in settings]
                runs[cell_key(algo, pb, n)] = {
                    "proposed": [p for p, _ in got],
                    "accepted": [a for _, a in got],
                    "settings": settings}
                print(cell_key(algo, pb, n), got, flush=True)
    out = {"source": "benchmarks/fig3_rejections.py run() per run, "
                     "repeats 0-2, from repro.core on the CPU",
           "jax": jax.__version__,
           "jax_threefry_partitionable": bool(
               jax.config.jax_threefry_partitionable),
           "grid": {"algos": list(ALGOS), "pbs": list(PBS), "ns": list(NS)},
           "benchmark_repeats": 20, "repeats": list(REPEATS), "runs": runs}
    # one line a count list and a run's settings
    text = json.dumps(out, indent=1)
    text = re.sub(r"\[\s+([-\d,\s]+?)\s+\]",
                  lambda m: "[" + " ".join(m.group(1).split()) + "]", text)
    text = re.sub(r"\{\s+(\"entry\"[^{}]*?)\s+\}",
                  lambda m: "{" + " ".join(m.group(1).split()) + "}", text)
    GOLDEN.write_text(text + "\n")
    print(f"wrote {GOLDEN} in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)


if __name__ == "__main__":
    main()
