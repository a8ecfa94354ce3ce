"""Compare the port's integrals between two checkouts of the repo, on the
CPU: are they the same bits?

    python scripts/compare_integrals.py <checkout_a> <checkout_b> [basis]

For water (``utils.measure.WATER``) at ``basis`` (def2-TZVP by default:
f shells on O, so every E and R recursion level of ``ints/md.py`` up to
l = 3 per centre runs), each checkout computes in a process of its own: S,
T, V and the dipole integrals, the DF tensors (P|ab), (P|Q) and the
attenuated (P|ab) at omega 0.33 (def2-universal-jkfit, the SCF's), the
in-core ERI tensor, and the nuclear gradient of (P|ab) contracted with a
fixed random weight (autograd). Prints, for each, whether the two are
bitwise equal, the largest difference, that relative to the largest
element, and how many elements differ.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np


def dump(root, basis, out):
    sys.path.insert(0, root)
    import torch
    torch.set_num_threads(2)
    from cctpu_torch.core.molecule import Molecule
    from cctpu_torch.dft.rks import RKS
    from cctpu_torch.ints import two_electron
    from cctpu_torch.ints.df import build_2c2e, build_3c2e
    from cctpu_torch.ints.one_electron import build_int1e_eager
    from cctpu_torch.utils.measure import WATER
    mol = Molecule.from_atoms(WATER, basis=basis)
    R = torch.as_tensor(mol.coords)
    charges = torch.as_tensor(mol.charges, dtype=R.dtype)
    res = {k: v.numpy() for k, v in build_int1e_eager(
        mol.basis_set, R, charges, with_dipole=True).items()}
    aux = RKS(mol, density_fit=True, device="cpu").get_jk_builder().aux
    res["3c"] = build_3c2e(mol.basis_set, aux, R).numpy()
    res["2c"] = build_2c2e(aux, R).numpy()
    res["3c_lr"] = build_3c2e(mol.basis_set, aux, R, 0.33).numpy()
    res["4c"] = two_electron.build_eri_incore(mol.basis_set, R).numpy()
    leaf = R.clone().requires_grad_(True)
    w = torch.as_tensor(np.random.default_rng(1).standard_normal(
        res["3c"].shape))
    g, = torch.autograd.grad((build_3c2e(mol.basis_set, aux, leaf) * w)
                             .sum(), leaf)
    res["3c_grad"] = g.numpy()
    np.savez(out, **res)


def main(argv):
    if argv[0] == "--dump":
        dump(*argv[1:])
        return
    a, b = (os.path.abspath(p) for p in argv[:2])
    basis = argv[2] if len(argv) > 2 else "def2-tzvp"
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i, root in enumerate((a, b)):
            files.append(os.path.join(tmp, f"{i}.npz"))
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--dump", root, basis, files[-1]], check=True)
        x, y = (np.load(f) for f in files)
        for k in x.files:
            d = np.abs(x[k] - y[k])
            print(f"{k:8s} {str(x[k].shape):18s} bitwise "
                  f"{np.array_equal(x[k], y[k])!s:5s} max {d.max():.3g} "
                  f"relative {d.max() / np.abs(x[k]).max():.3g} "
                  f"differing {int((d > 0).sum())} of {d.size}")


if __name__ == "__main__":
    main(sys.argv[1:])
