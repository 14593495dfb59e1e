"""CLI entry point: prm file -> full pipeline, reference log schema.

The analogue of the reference's tests_2D suites that run the MAIN BINARY on
a .prm file (tests_2D/CMakeLists.txt:2 `SET(TEST_TARGET ${TARGET})`) and
diff its stdout.
"""

import os
import re

import pytest


def test_cli_runs_prm_and_prints_reference_schema(capsys, tmp_path,
                                                  monkeypatch):
    from coulomb_gmg.cli import main

    prm = tmp_path / "mini.prm"
    prm.write_text("""
subsection Geometry
  set Number of global refinement = 2
  set Domain limit left = 0.0
  set Domain limit right = 1.0
end
subsection Misc
  set Number of Adaptive Refinement = 2
  set Output time summary table = false
end
subsection Problem Selection
  set Problem = Step16
  set Dimension = 2
  set Boundary conditions selection = Homogeneous
end
subsection Solver input data
  set Preconditioner = GMG
end
""")
    rc = main([str(prm), "--cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    # the reference's per-cycle line schema (the out_parser.py oracle)
    assert "Problem type is:   Step16" in out
    assert out.count("Cycle ") == 2
    assert re.search(r"Number of active cells:\s+\d+", out)
    assert re.search(r"Number of degrees of freedom: \d+ \(by level", out)
    assert re.search(r"L2 rhs norm \d\.\d{10}e[+-]\d\d", out)
    assert re.search(r"CG converged in \d+ iterations\.", out)
    assert re.search(r"Threshold value for refinement:\t", out)


def test_cli_rejects_bad_selection(tmp_path):
    from coulomb_gmg.cli import main
    prm = tmp_path / "bad.prm"
    prm.write_text("""
subsection Solver input data
  set Preconditioner = BICGSTAB
end
""")
    with pytest.raises(Exception):
        main([str(prm), "--cpu"])
