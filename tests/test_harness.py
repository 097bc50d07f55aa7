"""Config-run mode and measurement-harness tests."""

import json
import subprocess
import sys

import numpy as np

from hwbloomradixjoin import confrun


def test_parse_conf_json_and_libconfigish():
    j = confrun.parse_conf(json.dumps({"algorithm": "NPO", "threads": 4}))
    assert j["algorithm"] == "NPO" and j["threads"] == 4
    lc = confrun.parse_conf(
        'algorithm = "PRO";\nbuild.size = 1000; // c\nprobe.selectivity = 0.5;\n'
        'engine.backend = "cpu";\n')
    assert lc["algorithm"] == "PRO"
    assert lc["build"]["size"] == 1000
    assert lc["probe"]["selectivity"] == 0.5
    assert lc["engine"]["backend"] == "cpu"


def test_confrun_end_to_end(tmp_path, capsys):
    conf = {
        "algorithm": "NPO_st",
        "threads": 3,
        "build": {"size": 37, "seed": 12345},
        "probe": {"size": 101, "seed": 54321, "selectivity": 0.7},
        "engine": {"backend": "cpu"},
    }
    p = tmp_path / "x.conf"
    p.write_text(json.dumps(conf))
    rc = confrun.main([str(p)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Results = 71. DONE." in out  # reference-validated count
    assert "RUNTIME TOTAL, BUILD+PART, PART (cycles):" in out


def test_parse_result_roundtrip():
    sys.path.insert(0, "measurements")
    from measurements.run import parse_result

    sample = (
        "[INFO ] Creating relation R with size = 0.763 MiB, #tuples = 100000 : OK \n"
        "[INFO ] Creating relation S with size = 3.052 MiB, #tuples = 400000 : OK \n"
        "[INFO ] Running join algorithm PRO ...\n"
        "S-tuples after filter: 109229\n"
        "RUNTIME TOTAL, BUILD, PART (cycles): \n"
        "13777668 \t 1429536 \t 0 \n"
        "TOTAL-TIME-USECS, TOTAL-TUPLES, NSEC-PER-TUPLE: \n"
        "6562.0000 \t 100000 \t 16.4050 \n"
        "PARTITION-TIME-USECS, PROBE-TIME-USECS, JOIN-TIME-USECS: \n"
        "0.0000 \t 5881.0000\t 6562.0000 \n"
        "[INFO ] Results = 100000. DONE.\n")
    d = parse_result(sample)
    assert d["s-size"] == 400000
    assert d["filtered"] == 109229
    assert d["runtime-cycles"] == 13777668
    assert d["nsec-per-tuple"] == 16.405
    assert d["results"] == 100000


def test_cli_subprocess_matches_reference_count():
    proc = subprocess.run(
        [sys.executable, "-m", "hwbloomradixjoin.cli", "-a", "NPO_st",
         "-r", "12345", "-s", "54321", "-n", "7", "-q", "0.999",
         "--engine-backend", "cpu"],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-1500:]
    assert "Results = 54267. DONE." in proc.stdout
