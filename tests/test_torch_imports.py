"""The PyTorch port stands alone: importing it pulls in neither jax nor the
JAX package, and no module of it imports them."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "ctdirect_tpu_torch"


def test_import_leaves_jax_out():
    code = (
        "import sys; import ctdirect_tpu_torch, ctdirect_tpu_torch.parallel, "
        "ctdirect_tpu_torch.problems, ctdirect_tpu_torch.solver.cr_kernel, "
        "ctdirect_tpu_torch.utils.structure, ctdirect_tpu_torch.utils.profiling, "
        "ctdirect_tpu_torch.utils.plot, ctdirect_tpu_torch.parallel.time_shard, "
        "ctdirect_tpu_torch.parallel.spmd, ctdirect_tpu_torch.entry, ctdirect_tpu_torch.multihost, "
        "ctdirect_tpu_torch.latency_lab, ctdirect_tpu_torch.native, ctdirect_tpu_torch.solver.scan_kernel; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ctdirect_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_no_module_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ctdirect_tpu)\b", re.M)
    offenders = [
        str(p.relative_to(ROOT)) for p in PKG.rglob("*.py") if pattern.search(p.read_text())
    ]
    assert not offenders, offenders
