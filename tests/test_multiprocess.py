"""Multi-process (2-host analog) distributed execution test.

VERDICT round-1 item 5: the ``jax.distributed`` path had never been
executed.  This test spawns TWO separate Python processes (the CPU analog of
two hosts), initializes the distributed runtime through
``parallel.mesh.init_distributed``, builds a global 2-device mesh spanning
both processes, psums a token, and runs one candidate-sharded LM level solve
(``parallel.sharded.solve_level_point_sharded``) on a real synthetic
tracking problem — asserting in each process that the multi-process result
matches the process-local unsharded solve.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = r'''
import os, sys
os.environ.pop("JAX_PLATFORMS", None)
import jax
jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
except Exception:
    pass

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
sys.path.insert(0, {repo!r})

from visual_odometry_rs_tpu.parallel import mesh as mesh_mod

mesh_mod.init_distributed(
    coordinator_address=f"localhost:{{port}}", num_processes=nproc, process_id=pid
)
assert jax.device_count() == nproc, jax.device_count()

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

mesh = mesh_mod.make_mesh((nproc,), ("points",))

# 1) psum a token across processes
tok = jax.jit(
    jax.shard_map(
        lambda x: jax.lax.psum(x.sum(), "points"),
        mesh=mesh, in_specs=P("points"), out_specs=P(),
    )
)
x = np.arange(nproc * 3, dtype=np.float32).reshape(nproc, 3)
xs = jax.make_array_from_callback(
    x.shape, NamedSharding(mesh, P("points")), lambda idx: x[idx]
)
got = float(tok(xs).addressable_data(0))
assert got == float(x.sum()), (got, x.sum())
print(f"proc {{pid}}: psum ok", flush=True)

# 2) one candidate-sharded LM solve on a real tracking level
from visual_odometry_rs_tpu.dataset import synthetic
from visual_odometry_rs_tpu.math import pose as pose_mod
from visual_odometry_rs_tpu.models import tracker as tracker_mod
from visual_odometry_rs_tpu.ops import pyramid as pyramid_ops
from visual_odometry_rs_tpu.parallel import sharded as sharded_mod

seq = synthetic.generate_sequence(nb_frames=2, height=48, width=64, seed=7)
config = tracker_mod.TrackerConfig(height=48, width=64, nb_levels=3, candidate_cap=256)
pyr0 = pyramid_ops.mean_pyramid(config.nb_levels, jnp.asarray(seq.grays[0]))
kf = tracker_mod.precompute_keyframe(
    config, seq.intrinsics, jnp.asarray(seq.depths[0]), pyr0
)
obs = kf.levels[1]
pyr1 = pyramid_ops.mean_pyramid(config.nb_levels, jnp.asarray(seq.grays[1]))
image = pyr1[1]

# local (single-process) reference
ref = tracker_mod.solve_level(obs, image, pose_mod.identity(), interp_method="gather")
ref_q = np.asarray(ref.state.model.q)
ref_t = np.asarray(ref.state.model.t)

# global arrays: candidate axis sharded across the two processes
def globalize(a, sharded):
    a = np.asarray(a)
    spec = P("points", *([None] * (a.ndim - 1))) if sharded else P()
    return jax.make_array_from_callback(
        a.shape, NamedSharding(mesh, spec), lambda idx: a[idx]
    )

obs_g = tracker_mod.LevelObs(
    intrinsics=jax.tree_util.tree_map(lambda v: globalize(v, False), obs.intrinsics),
    template=globalize(obs.template, False),
    xs=globalize(obs.xs, True),
    ys=globalize(obs.ys, True),
    idepth=globalize(obs.idepth, True),
    valid=globalize(obs.valid, True),
    tmpl_vals=globalize(obs.tmpl_vals, True),
    jacobians=globalize(obs.jacobians, True),
)
image_g = globalize(image, False)
ident = pose_mod.identity()
model_g = pose_mod.Pose(globalize(ident.q, False), globalize(ident.t, False))

model, failed, nb_iter = sharded_mod.solve_level_point_sharded(
    obs_g, image_g, model_g, mesh, "points", interp_method="gather"
)
q = np.asarray(model.q.addressable_data(0))
t = np.asarray(model.t.addressable_data(0))
assert not bool(np.asarray(failed.addressable_data(0)))
np.testing.assert_allclose(q, ref_q, atol=5e-5)
np.testing.assert_allclose(t, ref_t, atol=5e-5)
print(f"proc {{pid}}: sharded solve ok ({{int(np.asarray(nb_iter.addressable_data(0)))}} iters)", flush=True)
'''


def test_two_process_distributed_solve(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(repo=repo))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)  # workers use 1 CPU device each
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"proc {i} failed:\n{out}\n{err}"
        assert "psum ok" in out and "sharded solve ok" in out, (out, err)
