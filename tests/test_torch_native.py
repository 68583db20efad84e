"""
The port's native host runtime (``uf3_tpu_torch/native``) against the
port's Python extended-xyz reader (its plain version), the JAX
package's native library (``uf3_tpu.native``) and the port's own
neighbor lists:

- the tokenizer reads what ``read_xyz_python`` reads, configuration by
  configuration (numbers, positions, cells, pbc, info, arrays), on files
  the tests write: frames with and without ``Lattice``, energies
  missing, ``Properties`` with the positions after the forces, a frame
  without forces among frames with them, extra numeric and string
  columns;
- the reference's tokenizer agrees where it is right and shows its
  faults where the port does not copy them: a frame without force
  columns reads as zero forces, positions come from columns 1-3 whatever
  ``Properties`` says, an unknown species becomes Z = -1 (the port
  raises, as the Python reader does);
- ``read_xyz`` sends a file of the standard layout to the tokenizer and
  keeps ``StringIO`` and per-axis ``pbc=`` files on the Python reader;
- a build that fails raises with the compiler's command and output;
- the cell list (the twin of ``tests/test_auxiliary.py``'s
  ``TestNative``): neighbor sets per row and the largest count against
  the reference's native list and the port's O(N^2) list, and, where a
  direction holds a single bin, against the port's explicit-image list (the
  reference's list misses the +1 images there).
"""

import os

import numpy as np
import pytest
import torch

from uf3_tpu import native as j_native
from uf3_tpu_torch import native
from uf3_tpu_torch.data import io
from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.ops import neighbors as nb

torch.set_num_threads(1)


def _frames(seed=0, n_frames=6, forces=True):
    rng = np.random.RandomState(seed)
    frames = []
    for i in range(n_frames):
        geom = bulk("W", "bcc", a=3.16) * (2, 1 + i % 2, 2)
        geom.rattle(0.05, seed=seed + i)
        if i % 3 != 2:
            geom.info["energy"] = float(rng.randn() * 10)
        if forces:
            f = rng.randn(len(geom), 3)
            geom.arrays["fx"], geom.arrays["fy"], geom.arrays["fz"] = f.T
        frames.append(geom)
    return frames


def _assert_same(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert np.array_equal(a.numbers, b.numbers)
        assert np.array_equal(a.positions, b.positions)
        assert np.array_equal(a.cell, b.cell)
        assert np.array_equal(a.pbc, b.pbc)
        assert a.info == b.info
        assert list(a.arrays) == list(b.arrays)
        for key in a.arrays:
            assert a.arrays[key].dtype == b.arrays[key].dtype
            assert np.array_equal(a.arrays[key], b.arrays[key])


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def _line(symbol, *values):
    return " ".join([symbol] + [repr(float(v)) for v in values])


def test_tokenizer_matches_python_reader(tmp_path):
    """Frames with and without Lattice (a cluster), energies missing, an
    info key, blank lines between frames, CRLF line ends."""
    frames = _frames()
    frames[3].cell[:] = 0.0
    frames[3].pbc[:] = False
    frames[1].info["stress_tag"] = 7.5
    path = str(tmp_path / "set.xyz")
    io.write_xyz(path, frames)
    ours = native.parse_extxyz_fast(path)
    _assert_same(ours, io.read_xyz_python(path))
    assert not np.any(ours[3].pbc) and "energy" not in ours[2].info
    with open(path) as f:
        text = f.read()
    spaced = "".join(f"\n  \n{line}" if line.isdigit() else f"\n{line}"
                     for line in text.split("\n"))
    assert spaced.count("\n  \n") == len(frames)
    crlf = _write(tmp_path / "crlf.xyz", spaced.replace("\n", "\r\n"))
    _assert_same(native.parse_extxyz_fast(crlf), io.read_xyz_python(crlf))


def test_reference_tokenizer_agrees_on_the_standard_layout(tmp_path):
    frames = _frames(seed=1)
    path = str(tmp_path / "set.xyz")
    io.write_xyz(path, frames)
    ours = native.parse_extxyz_fast(path)
    ref = j_native.parse_extxyz_fast(path)
    for a, b in zip(ours, ref):
        assert np.array_equal(a.numbers, b.numbers)
        assert np.array_equal(a.positions, b.positions)
        assert np.array_equal(a.cell, b.cell)
        assert a.info.get("energy") == b.info.get("energy")
        for c in ("fx", "fy", "fz"):
            assert np.array_equal(a.arrays[c], b.arrays[c])


def test_frame_without_forces_has_none(tmp_path):
    """Reference fault: ``has_forces`` is file-wide, so the frame with no
    force columns reads as zero forces there."""
    frames = _frames(seed=2, n_frames=3)
    for c in ("fx", "fy", "fz"):
        del frames[1].arrays[c]
    path = str(tmp_path / "mixed.xyz")
    io.write_xyz(path, frames)
    ours = native.parse_extxyz_fast(path)
    _assert_same(ours, io.read_xyz_python(path))
    assert "fx" not in ours[1].arrays and "fx" in ours[0].arrays
    ref = j_native.parse_extxyz_fast(path)
    assert np.all(ref[1].arrays["fx"] == 0.0)


def test_positions_where_properties_puts_them(tmp_path):
    """Reference fault: positions from token columns 1-3 whatever
    ``Properties`` says; here the forces come first."""
    rng = np.random.RandomState(3)
    x, f = rng.rand(4, 3) * 5, rng.randn(4, 3)
    lines = ["4", 'Lattice="5 0 0 0 5 0 0 0 5" '
             "Properties=species:S:1:forces:R:3:pos:R:3 energy=-3.25"]
    lines += [_line("W", *f[i], *x[i]) for i in range(4)]
    path = _write(tmp_path / "order.xyz", "\n".join(lines) + "\n")
    ours = native.parse_extxyz_fast(path)
    _assert_same(ours, io.read_xyz_python(path))
    assert np.array_equal(ours[0].positions, x)
    assert np.array_equal(ours[0].arrays["fx"], f[:, 0])
    ref = j_native.parse_extxyz_fast(path)
    assert np.array_equal(ref[0].positions, f)


def test_unknown_species_raises(tmp_path):
    """Reference fault: an unknown symbol becomes Z = -1 with no error."""
    lines = ["2", 'Lattice="5 0 0 0 5 0 0 0 5" Properties=species:S:1:pos:R:3',
             _line("W", 0, 0, 0), _line("Qq", 1, 1, 1)]
    path = _write(tmp_path / "bad.xyz", "\n".join(lines) + "\n")
    with pytest.raises(KeyError, match="Qq"):
        native.parse_extxyz_fast(path)
    with pytest.raises(KeyError, match="Qq"):
        io.read_xyz_python(path)
    assert list(j_native.parse_extxyz_fast(path)[0].numbers) == [74, -1]


def test_extra_columns_and_string_frames(tmp_path):
    """Integer and width-1 real columns go through the tokenizer; a frame
    with a string column besides the species is read by the Python
    reader from its own text, in place."""
    rng = np.random.RandomState(4)
    lines = ["3", 'Lattice="6 0 0 0 6 0 0 0 6" Properties=species:S:1:pos:'
             "R:3:tags:I:1:charge:R:1 energy=1.5 Time=0.25 label=run1"]
    lines += [_line("Ne", *rng.rand(3) * 6) + f" {i} {float(rng.randn())!r}"
              for i in range(3)]
    lines += ["2", 'Properties=species:S:1:pos:R:3:note:S:1 energy=2.0']
    lines += [_line("Xe", *rng.rand(3)) + f" tag{i}" for i in range(2)]
    path = _write(tmp_path / "extra.xyz", "\n".join(lines) + "\n")
    ours = native.parse_extxyz_fast(path)
    _assert_same(ours, io.read_xyz_python(path))
    assert list(ours[0].arrays["tags"]) == [0, 1, 2]
    assert ours[0].info["Time"] == 0.25 and ours[0].info["label"] == "run1"
    assert list(ours[1].arrays["note"]) == ["tag0", "tag1"]


def test_read_xyz_routes_by_layout(tmp_path, monkeypatch):
    frames = _frames(seed=5, n_frames=2)
    path = str(tmp_path / "set.xyz")
    io.write_xyz(path, frames)
    calls = []
    fast = native.parse_extxyz_fast
    monkeypatch.setattr(native, "parse_extxyz_fast",
                        lambda name: calls.append(name) or fast(name))
    _assert_same(io.read_xyz(path), io.read_xyz_python(path))
    assert calls == [path]
    _assert_same(io.read_xyz(path, index=slice(1, None)),
                 io.read_xyz_python(path)[1:])
    with open(path) as f:
        text = f.read()
    assert len(io.read_xyz(io.StringIO(text))) == 2
    axis = _write(tmp_path / "axis.xyz", text.replace(
        "Properties=", 'pbc="T T F" Properties=', 1))
    geoms = io.read_xyz(axis)
    assert len(calls) == 2 and list(geoms[0].pbc) == [True, True, False]
    keys, found = io.read_sources([path])
    assert len(calls) == 3 and keys == ["set.xyz_0", "set.xyz_1"]
    _assert_same(found, io.read_xyz_python(path))


def test_failed_build_raises(tmp_path, monkeypatch):
    broken = _write(tmp_path / "broken.cpp", "int f( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "LIBRARY",
                        str(tmp_path / "build" / "libuf3native.so"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ -O3") as info:
        native.load()
    assert "broken.cpp" in str(info.value) and "error" in str(info.value)
    assert not os.listdir(tmp_path / "build")


def _sets(idx, mask, shift=None):
    rows = []
    for i in range(idx.shape[0]):
        live = np.flatnonzero(mask[i])
        if shift is None:
            rows.append(sorted(int(j) for j in idx[i, live]))
        else:
            rows.append(sorted((int(idx[i, k]),) + tuple(
                int(round(s)) for s in shift[i, k]) for k in live))
    return rows


def test_cell_list_matches_reference_and_device_list():
    """The twin of ``tests/test_auxiliary.py::TestNative``."""
    geom = bulk("W", "bcc", a=3.16) * 4
    geom.rattle(0.03, seed=2)
    r_cut = 4.0
    idx, shift, mask, max_count = native.cell_list_neighbors(
        geom.positions, geom.cell, geom.pbc, r_cut, 64)
    r_idx, r_shift, r_mask, r_max = j_native.cell_list_neighbors(
        geom.positions, geom.cell, geom.pbc, r_cut, 64)
    assert max_count == r_max == 14
    assert _sets(idx, mask, shift) == _sets(r_idx, r_mask, r_shift)
    dev = nb.build_neighbor_list(
        torch.as_tensor(geom.positions), torch.as_tensor(geom.cell),
        tuple(geom.pbc), r_cut, 64)
    assert _sets(idx, mask) == _sets(dev.idx.numpy(), dev.mask.numpy())
    assert np.array_equal(np.sort(mask.sum(axis=1)),
                          np.sort(dev.mask.numpy().sum(axis=1)))
    # a capacity below the count keeps the first rows and reports it
    _, _, small, count = native.cell_list_neighbors(
        geom.positions, geom.cell, geom.pbc, r_cut, 8)
    assert count == 14 and small.sum(axis=1).max() == 8


def test_cell_list_single_bin_direction():
    """A cell 2 x 3.16 A wide at r_cut 4 A holds one bin a direction:
    every image within the cutoff, as the port's explicit-image list finds
    them (reference fault: its list skips the +1 images)."""
    geom = bulk("W", "bcc", a=3.16) * 2
    geom.rattle(0.03, seed=2)
    r_cut = 4.0
    idx, shift, mask, max_count = native.cell_list_neighbors(
        geom.positions, geom.cell, geom.pbc, r_cut, 64)
    x = torch.as_tensor(geom.positions)
    cell = torch.as_tensor(geom.cell)
    images = nb.images_required(geom.cell, geom.pbc, r_cut)
    dev = nb.build_neighbor_list_images(nb.wrap_positions(x, cell, (True,) * 3),
                                        cell, (True,) * 3, r_cut, 64, images)
    ours = _sets(idx, mask, shift)
    theirs = _sets(dev.idx.numpy(), dev.mask.numpy(), dev.shift.numpy())
    assert ours == theirs
    assert max_count == 14 and np.all(mask.sum(axis=1) == 14)
    ref_mask = j_native.cell_list_neighbors(
        geom.positions, geom.cell, geom.pbc, r_cut, 64)[2]
    assert ref_mask.sum(axis=1).min() < 14


def test_malformed_count_raises(tmp_path):
    lines = ["2 atoms", "Properties=species:S:1:pos:R:3", _line("W", 0, 0, 0),
             _line("W", 1, 1, 1)]
    path = _write(tmp_path / "count.xyz", "\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="atom count"):
        native.parse_extxyz_fast(path)
    with pytest.raises(ValueError):
        io.read_xyz_python(path)
    with pytest.raises(FileNotFoundError):
        native.parse_extxyz_fast(str(tmp_path / "missing.xyz"))
