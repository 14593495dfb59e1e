"""VTU/PVTU/VisIt output (io/vtu.py — the analogue of
src/step-50.cc:1149-1308): files must be well-formed XML with consistent
piece/point/cell counts and parseable back."""

import os
import xml.etree.ElementTree as ET

import numpy as np

from coulomb_gmg.mesh.forest import Forest
from coulomb_gmg.io.vtu import (write_vtu, write_pvtu,
                                write_visit_record, nodal_gradient)


def test_vtu_roundtrip(tmp_path):
    f = Forest.uniform(3, 4, np.zeros(3), 0.25)
    u = np.linspace(0.0, 1.0, f.dofs.n_dofs)
    grad = nodal_gradient(f, u)
    piece = str(tmp_path / "solution-00000.0000.vtu")
    write_vtu(piece, f, {"solution": u, "grad_phi": grad},
              {"subdomain": np.zeros(f.n_cells)})
    root = ET.parse(piece).getroot()
    assert root.tag == "VTKFile"
    pd = root.find(".//Piece")
    assert int(pd.get("NumberOfCells")) == f.n_cells
    names = {d.get("Name") for d in root.findall(".//DataArray")}
    assert {"solution", "grad_phi", "subdomain"} <= names

    master = str(tmp_path / "solution-00000.pvtu")
    write_pvtu(master, [piece], point_names=["solution", "grad_phi"],
               cell_names=["subdomain"])
    proot = ET.parse(master).getroot()
    assert proot.tag == "VTKFile"
    assert len(proot.findall(".//Piece")) == 1

    visit = str(tmp_path / "solution-00000.visit")
    write_visit_record(visit, [piece])
    assert os.path.getsize(visit) > 0


def test_nodal_gradient_linear_field_exact():
    # u = 2x - 3y + z has constant gradient; nodal_gradient renders the
    # FIELD -grad(phi) (GradientPostprocessor, src/step-50.cc:1123-1147)
    f = Forest.uniform(3, 5, np.zeros(3), 0.2)
    pos = f.dofs.positions
    u = 2 * pos[:, 0] - 3 * pos[:, 1] + pos[:, 2]
    g = nodal_gradient(f, u)
    assert np.allclose(g, -np.array([2.0, -3.0, 1.0]), atol=1e-12)


def test_vtu_binary_encoding_roundtrip(tmp_path):
    """Binary (zlib+base64) DataArrays decode back to the exact values
    and stay well-formed XML; the file is much smaller than ascii."""
    import base64
    import zlib

    f = Forest.uniform(3, 6, np.zeros(3), 1.0 / 6)
    u = np.sin(np.arange(f.dofs.n_dofs, dtype=np.float64))
    pa = str(tmp_path / "a.vtu")
    pb = str(tmp_path / "b.vtu")
    write_vtu(pa, f, {"solution": u}, encoding="ascii")
    write_vtu(pb, f, {"solution": u}, encoding="binary")
    assert os.path.getsize(pb) < 0.5 * os.path.getsize(pa)

    root = ET.parse(pb).getroot()
    assert root.get("compressor") == "vtkZLibDataCompressor"
    da = [d for d in root.findall(".//DataArray")
          if d.get("Name") == "solution"][0]
    blob = da.text.strip()
    header = np.frombuffer(base64.b64decode(blob[:44]), np.uint64)
    assert header[0] == 1 and header[1] == header[2] == 8 * len(u)
    payload = base64.b64decode(blob[44:])
    dec = np.frombuffer(zlib.decompress(payload), np.float64)
    np.testing.assert_array_equal(dec, u)

    conn = [d for d in ET.parse(pb).getroot().findall(".//DataArray")
            if d.get("Name") == "connectivity"][0]
    blob = conn.text.strip()
    payload = base64.b64decode(blob[44:])
    dec = np.frombuffer(zlib.decompress(payload), np.int64)
    ref = f.dofs.cell2dof[:, [0, 1, 3, 2, 4, 5, 7, 6]].reshape(-1)
    np.testing.assert_array_equal(dec, ref)
