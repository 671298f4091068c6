"""A configuration, a traffic mix and a metric added as new files (and
entries in BENCHMARK.json) alone are found and run: no file of the
harness is edited. A pencil configuration on four ranks is such a file;
a mix whose planner keywords a configuration cannot run is refused."""

import json

import pytest

from h100bench import run
from helpers import last_json, tiny_root


def _add(root, config=None, traffic=None, workload=None, **metrics):
    hb = root / "h100bench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if config is not None:
        (hb / "configs" / f"{config['name']}.json").write_text(
            json.dumps(config))
        bench["configs"].append({
            "name": config["name"], "source": "x", "reduced": [],
            "file": f"h100bench/configs/{config['name']}.json",
            "why": "a test"})
    if traffic is not None:
        name, mix = traffic
        (hb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    if workload is not None:
        bench["workloads"].append({**workload, "why": "a test"})
    for section, entries in metrics.items():
        for entry, code in entries:
            (hb / "metrics" / f"{entry['name']}.py").write_text(code)
            bench[section].append(entry)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def _config(name, **kw):
    return {"name": name, "shape": [8, 8, 16], "ranks": 1,
            "decomposition": "single", "precision": "float32", "reduced": [],
            "reference": "fft3d",
            "limits": {"fwd_err": 1e-4, "bwd_err": 1e-4},
            "control": {"kind": "reference_lowp"}, **kw}


def _main(root, cell, trace=0, seconds=0.2):
    return run.main(["--workload", cell, "--seed", "9", "--seconds",
                     str(seconds), "--trace", str(trace), "--cpu", "--root",
                     str(root)])


def test_cell_from_new_files(tmp_path, capsys):
    root = tiny_root(tmp_path)
    mix = json.loads((root / "h100bench" / "traffic" / "r2c.json")
                     .read_text())
    _add(root, config=_config("grid8_1card"),
         traffic=("r2c_again", {**mix, "about": "a test"}),
         workload={"name": "grid8_1card.r2c_again", "config": "grid8_1card",
                   "traffic": "r2c_again", "chips": 1},
         end_to_end=[({"name": "pairs_per_s", "unit": "1/s",
                       "better": "higher", "bound": 0.05,
                       "source": "host_clock",
                       "workloads": ["grid8_1card.r2c_again"]},
                      "def read(ctx):\n"
                      "    return ctx.transforms / 2 / ctx.window_s\n")],
         per_layer=[({"name": "host_call_us", "unit": "us",
                      "better": "lower", "source": "host_clock",
                      "layer": "plan and API", "moves": "gflops",
                      "workloads": ["grid8_1card.r2c_again"]},
                     "REDUCE = 'max'\n\n\ndef read(ctx):\n"
                     "    return 1e6 * max(ctx.host_call_s)\n")])
    for trace, want in ((0, {"gflops", "setup_s", "pairs_per_s"}),
                        (1, {"host_call_us"})):
        rc = _main(root, "grid8_1card.r2c_again", trace)
        out, err = capsys.readouterr()
        assert rc == 0, err
        line = last_json(out)
        assert line["correct"]
        assert set(line["metrics"]) == want
    # the old cells do not report the new cell's metrics
    rc = _main(root, "grid512_1card.c2c")
    out, _ = capsys.readouterr()
    assert rc == 0 and "pairs_per_s" not in last_json(out)["metrics"]


def test_pencil_configuration_from_a_file(tmp_path, capsys):
    """2x2 pencils (heFFTe's ``-pencils``): boxes cut along two axes on
    each side, read from the plans, gathered for the check."""
    root = tiny_root(tmp_path)
    _add(root, config=_config(
        "grid8_pencil4", ranks=4, decomposition="pencil", grid=[2, 2],
        plan={"algorithm": "alltoall", "overlap_chunks": 1,
              "wire_dtype": "none"}),
        workload={"name": "grid8_pencil4.c2c", "config": "grid8_pencil4",
                  "traffic": "c2c", "chips": 4})
    rc = _main(root, "grid8_pencil4.c2c")
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = last_json(out)
    assert line["correct"] is True and line["device"]["count"] == 4
    assert {"gflops", "setup_s"} <= set(line["metrics"])


def test_exchange_keywords_on_one_rank_are_refused(tmp_path):
    """A mix that asks for a lower-precision wire, on a configuration
    with no exchange, would time the exact plan: it fails instead."""
    root = tiny_root(tmp_path)
    _add(root, traffic=("c2c_split", {"transform": "c2c",
                                      "flops_factor": 5.0,
                                      "plan": {"wire_dtype": "split",
                                               "fuse": True},
                                      "about": "a test"}),
         workload={"name": "grid512_1card.c2c_split",
                   "config": "grid512_1card", "traffic": "c2c_split",
                   "chips": 1})
    with pytest.raises(ValueError, match="wire_dtype"):
        _main(root, "grid512_1card.c2c_split")
