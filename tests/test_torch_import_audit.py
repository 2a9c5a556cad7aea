"""The port imports neither jax, nor any module of the JAX package, nor
the `cryptography` wheel: a fresh interpreter imports every port module,
runs the CPU verify path, commits one small block through the port's
Committer on the CPU and verifies one idemix presentation on the host
path, then inspects sys.modules."""
import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import torch
torch.set_num_threads(1)
import fabric_mod_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
from fabric_mod_tpu_torch.bccsp import gpu
from fabric_mod_tpu_torch.utils import fixtures
items, expect = fixtures.make_block(0, n_tx=1, raw_endorsers=True,
                                    adversarial=False)
got = gpu.GpuVerifier(device="cpu").verify_many(items)
assert got.tolist() == expect.tolist(), (got, expect)
from fabric_mod_tpu_torch.protos import messages
world = fixtures.make_commit_world()
blocks, flags = fixtures.make_commit_blocks(world, 1, 2)
committer = world.committer(gpu.GpuVerifier(device="cpu"), tensor_policy=True)
assert committer.store_block(messages.Block.decode(blocks[0])) == flags[0]
assert committer.ledger.height == 1
from fabric_mod_tpu_torch.idemix import credential
idemix = fixtures.make_idemix_world(seed=1, n_users=1)
pres, want = fixtures.make_presentations(idemix, 1)
assert credential.batch_verify(idemix.issuer.key, pres,
                               use_device=False) == want == [True]
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "fabric_mod_tpu" or n.startswith("fabric_mod_tpu.")
             or n == "cryptography" or n.startswith("cryptography."))
print(json.dumps(bad))
"""


def test_port_loads_no_jax_and_no_reference_module():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
