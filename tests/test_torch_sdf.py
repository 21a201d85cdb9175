"""Port parity for the SDF slice's data and field: the mesh library's signed
distance, surface sampling and OBJ reader, `SDFDataset.sample` (bit for bit,
two seeds, on `tests/test_sdf.py`'s 32^3 sphere with 2048 samples), and
`SDFNetwork.cf` at its full width (16 levels of 2^19 rows, 3x64 MLP) on
4,096 points, some outside [-1, 1], against the JAX package's on the same
weights.

Tolerances.  The mesh library and the dataset are the same C++ source and
numpy calls: exact.  The f32 forward: 1e-5 absolute on outputs of order
0.1 (the 2^3 corner products and the MLP's sums in another order).  The
bf16 MLP (`--fp16`): 2e-2 norm-relative, the bf16 limit of the other bf16
comparisons (a layer's output rounds to bf16 in both packages, its products
summed in another order, so single roundings flip by a bf16 ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.data.sdf import SDFDataset as JaxSDFDataset
from tngp.models import SDFNetwork as JaxSDFNetwork
from tngp.native import MeshSDF as JaxMeshSDF
from tngp.native import load_obj as jax_load_obj
from tngp.native import marching_tetrahedra as jax_marching_tetrahedra
from tngp_torch.convert import ngp_state_dict_from_flax
from tngp_torch.data.sdf import SDFDataset, normalize_mesh, sphere_mesh
from tngp_torch.models import SDFNetwork
from tngp_torch.native import MeshSDF, load_obj, save_obj
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def jax_sphere(n=32, r=0.6):
    """`tests/test_sdf.py`'s sphere mesh, through the JAX package."""
    g = np.linspace(-1, 1, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    verts, faces = jax_marching_tetrahedra(r - np.sqrt(X**2 + Y**2 + Z**2), 0.0)
    return verts / (n - 1) * 2 - 1, faces


def test_mesh_library_and_obj_reader_match_jax(tmp_path):
    """`sphere_mesh`, `MeshSDF` (distances and surface samples) and
    `load_obj` give the JAX wrappers' arrays exactly."""
    verts, faces = jax_sphere()
    tv, tf = sphere_mesh(32, 0.6)
    np.testing.assert_array_equal(tv, verts)
    np.testing.assert_array_equal(tf, faces)
    nv = normalize_mesh(verts)
    jsdf, tsdf = JaxMeshSDF(nv, faces), MeshSDF(nv, faces)
    pts = np.random.default_rng(0).uniform(-1.2, 1.2, (5000, 3)).astype(np.float32)
    d = tsdf(pts)
    np.testing.assert_array_equal(d, jsdf(pts))
    inside = np.linalg.norm(pts, axis=1) < np.linalg.norm(nv, axis=1).min()
    assert inside.any() and (d[inside] > 0).all()  # positive inside
    np.testing.assert_array_equal(tsdf.sample_surface(777, seed=3),
                                  jsdf.sample_surface(777, seed=3))
    path = str(tmp_path / "sphere.obj")
    save_obj(path, verts, faces)
    for a, b in zip(load_obj(path), jax_load_obj(path)):
        np.testing.assert_array_equal(a, b)
    del tsdf  # frees its C++ state


def test_dataset_sample_equals_jax_bit_for_bit():
    """Points and labels for two seeds; labels 0 on the first half, minus
    the signed distance (positive outside) on the rest."""
    verts, faces = jax_sphere()
    jds = JaxSDFDataset(vertices=verts, faces=faces, num_samples=2048, size=2)
    tds = SDFDataset(vertices=verts, faces=faces, num_samples=2048, size=2)
    np.testing.assert_array_equal(tds.vertices, jds.vertices)
    for seed in (0, 12345):
        (jp, js), (tp, ts) = jds.sample(seed), tds.sample(seed)
        assert tp.dtype == np.float32 and ts.shape == (2048, 1)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(ts, js)
        assert not ts[:1024].any() and ts[1024:].any()
    with pytest.raises(ValueError, match="divisible by 8"):
        SDFDataset(vertices=verts, faces=faces, num_samples=2047)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_forward_at_full_width_matches_jax(bf16):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jnet = JaxSDFNetwork(compute_dtype=jdt)
    params = jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(0), jnp.zeros((8, 3))))
    rng = np.random.default_rng(1)
    emb = params["params"]["encoder"]["embeddings"]
    assert emb.shape == (6_119_864, 2)  # 16 levels of up to 2^19 rows
    params["params"]["encoder"]["embeddings"] = rng.normal(0, 0.1, emb.shape).astype(np.float32)
    tnet = SDFNetwork(compute_dtype=tdt, device="cpu")
    tnet.load_state_dict(ngp_state_dict_from_flax(params))
    x = rng.uniform(-1.1, 1.1, (3, 4096)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(x), method=JaxSDFNetwork.cf), np.float32)
    with torch.no_grad():
        got = tnet.cf(torch.from_numpy(x))
        batch_first = tnet(torch.from_numpy(np.ascontiguousarray(x.T)))
    assert got.dtype == torch.float32 and got.shape == (1, 4096)
    got = got.numpy()
    np.testing.assert_array_equal(batch_first.numpy(), got.T)
    if bf16:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 2e-2, rel
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    clipped = SDFNetwork(compute_dtype=tdt, device="cpu", clip_sdf=0.01)
    clipped.load_state_dict(tnet.state_dict())
    with torch.no_grad():
        c = clipped.cf(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(c, np.clip(got, -0.01, 0.01))
