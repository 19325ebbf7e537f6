"""initialize_multihost (SURVEY.md §5.8): the DCN-join path.

A real multi-host pod cannot exist in CI, but jax.distributed supports
local "clusters":

  * a single-process cluster exercises the join/mesh-build code path;
  * a REAL two-process cluster (two subprocesses, Gloo over localhost —
    the CPU stand-in for DCN) exercises cross-process collectives and
    the multi-host data feed (shard_batch_multihost) through the
    product eval path make_sharded_eval, asserting the globally-reduced
    WHDR equals the single-device computation on the full dataset.

Everything runs in subprocesses so the coordinator/client state never
leaks into the test session's runtime.
"""
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from reflectance_filtering.parallel.mesh import (
    initialize_multihost, shard_batch)

mesh = initialize_multihost(coordinator_address="localhost:12355",
                            num_processes=1, process_id=0)
assert jax.process_count() == 1 and jax.process_index() == 0
assert len(mesh.devices.flatten()) == 4, mesh
x = shard_batch(jnp.arange(8.0), mesh)
assert float(jnp.sum(x)) == 28.0
jax.distributed.shutdown()
print("MULTIHOST_OK")
"""


def _run(code, args=(), timeout=600):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=_ROOT)


def test_initialize_multihost_single_process_cluster():
    p = _run(_CODE)
    out, _ = p.communicate(timeout=600)
    assert p.returncode == 0, out
    assert "MULTIHOST_OK" in out


# Each of the two processes holds HALF of a 4-image eval set (its local
# slice, as a real pod host would after loading its dataset shard); the
# globally sharded eval must agree bit-for-bit with a plain single-device
# evaluation of the full set, on BOTH processes.
_CODE2 = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
jax.distributed.initialize("localhost:12357", num_processes=2,
                           process_id=pid)
import numpy as np, jax.numpy as jnp
from reflectance_filtering.parallel.mesh import (
    make_mesh, replicate, make_sharded_eval, shard_batch_multihost)
from reflectance_filtering.models.networks import (NetworkConfig,
                                                       init_network)
from reflectance_filtering.losses.whdr import whdr_per_image
from reflectance_filtering.models.recover import (
    recover_reflectance_shading)

assert jax.process_count() == 2 and jax.process_index() == pid
mesh = make_mesh()
assert len(mesh.devices.flatten()) == 4

cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=2,
                    num_filters_log=3, kernel_pad=0,
                    rs_est_mode="rDirectly")
params = init_network(jax.random.PRNGKey(0), cfg)

rng = np.random.RandomState(7)
imgs = rng.rand(4, 16, 16, 3).astype(np.float32)
comps = np.zeros((4, 5, 6), np.float32)
for i in range(4):
    comps[i, 0] = [0.2, 0.2, 0.7, 0.7, 1, 1.0]
    comps[i, 1] = [0.1, 0.8, 0.9, 0.1, 2, 0.5]
    comps[i, 4] = [2, 0, 0, 0, 0, 0]

loc = slice(2 * pid, 2 * pid + 2)
gi = shard_batch_multihost(imgs[loc], mesh)
gc = shard_batch_multihost(comps[loc], mesh)
assert gi.shape == (4, 16, 16, 3)

gv = shard_batch_multihost(np.ones(2, np.float32), mesh)
fn = make_sharded_eval(cfg, mesh)
mean, per = fn(replicate(params, mesh), gi, gc, gv)
got = float(mean)

# single-device reference on the full set (local devices only)
from reflectance_filtering.models.networks import apply_network
refl = jax.nn.relu(apply_network(params, jnp.asarray(imgs), cfg,
                                 train=False)["RS_est"])
want_per = np.asarray(whdr_per_image(refl, jnp.asarray(comps), 0.1))
# per-image WHDRs must match BITWISE on this process's shards; the mean
# crosses devices, so its reduction order may differ in the last bit
for s in per.addressable_shards:
    idx = s.index[0]
    np.testing.assert_array_equal(np.asarray(s.data), want_per[idx])
assert abs(got - float(np.mean(want_per))) < 1e-6, got
jax.distributed.shutdown()
print("PROC%d_OK %.6f" % (pid, got))
"""


def test_two_process_dcn_sharded_eval():
    p0 = _run(_CODE2, args=("0",))
    p1 = _run(_CODE2, args=("1",))
    out0, _ = p0.communicate(timeout=600)
    out1, _ = p1.communicate(timeout=600)
    assert p0.returncode == 0, out0
    assert p1.returncode == 0, out1
    assert "PROC0_OK" in out0 and "PROC1_OK" in out1
    # both processes converged on the same globally-reduced value
    v0 = out0.split("PROC0_OK")[1].split()[0]
    v1 = out1.split("PROC1_OK")[1].split()[0]
    assert v0 == v1, (v0, v1)


def test_shard_batch_multihost_single_process():
    """process_count==1 degenerate case: equals shard_batch."""
    import numpy as np
    import jax
    from reflectance_filtering.parallel.mesh import (
        make_mesh, shard_batch, shard_batch_multihost)

    mesh = make_mesh()
    x = np.arange(float(8 * len(mesh.devices.flatten()))).reshape(-1, 1)
    a = shard_batch(x, mesh)
    b = shard_batch_multihost(x, mesh)
    assert a.sharding == b.sharding
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
