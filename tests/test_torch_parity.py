"""Cross-framework numerics parity vs pure-PyTorch reimplementations.

The BASELINE.md gate: pixel/parameter grads allclose between this framework
and reference-semantics implementations written independently in torch
(behavioral specs: gridencoder/src/gridencoder.cu get_grid_index/kernel_grid,
testing/test_shencoder.py:8-50 SH oracle, nerf/renderer.py:126-254 `run` path).
Torch here is the CPU build; everything runs in float32 with documented
tolerances.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tngp.ops.hashgrid import HashGridSpec
from tngp.ops.sh import sh_encode_cf

_PRIMES = (1, 2654435761, 805459861)
_M32 = (1 << 32) - 1


# --------------------------------------------------------------------- helpers
def torch_hash_encode(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec):
    """Pure-torch multiresolution grid encode with uint32-emulated index math
    (gridencoder.cu:67-84,137-177 semantics; int64 ops masked to 32 bits)."""
    B = x.shape[0]
    D = spec.input_dim
    L, C = spec.num_levels, spec.level_dim
    offsets = spec.offsets
    outs = []
    for level in range(L):
        hashmap_size = offsets[level + 1] - offsets[level]
        scale = spec.level_scale(level)
        res = spec.level_resolution(level)
        side = res if spec.align_corners else res + 1
        shift = 0.0 if spec.align_corners else 0.5
        pos = x * scale + shift
        pos_grid = torch.floor(pos)
        frac = pos - pos_grid
        if spec.interpolation == "smoothstep":
            frac = frac * frac * (3.0 - 2.0 * frac)
        pg = pos_grid.to(torch.int64)
        level_out = torch.zeros(B, C, dtype=table.dtype)
        for corner in range(1 << D):
            cc = [pg[:, d] + ((corner >> d) & 1) for d in range(D)]
            # dense strided index while stride fits, else spatial hash
            index = torch.zeros(B, dtype=torch.int64)
            stride = 1
            for d in range(D):
                if stride > hashmap_size:
                    break
                index = (index + (cc[d] & _M32) * (stride & _M32)) & _M32
                stride *= side
            if spec.gridtype == "hash" and stride > hashmap_size:
                h = torch.zeros(B, dtype=torch.int64)
                for d in range(D):
                    h = h ^ ((cc[d] * _PRIMES[d]) & _M32)
                index = h & _M32
            rows = index % hashmap_size + offsets[level]
            w = torch.ones(B, dtype=table.dtype)
            for d in range(D):
                fd = frac[:, d].to(table.dtype)
                w = w * (fd if (corner >> d) & 1 else 1.0 - fd)
            level_out = level_out + w[:, None] * table[rows]
        outs.append(level_out)
    out = torch.stack(outs, dim=1).reshape(B, L * C)  # level-major like grid.py:59-69
    oob = ((x < 0) | (x > 1)).any(dim=1)
    return torch.where(oob[:, None], torch.zeros_like(out), out)


def _spec(gridtype="hash"):
    return HashGridSpec.create(
        num_levels=6, level_dim=2, base_resolution=4, log2_hashmap_size=7,
        desired_resolution=64, gridtype=gridtype,
    )


# ----------------------------------------------------------------- hash encode
# -------------------------------------------------------------------------- SH
def torch_sh_oracle(d: torch.Tensor, degree: int) -> torch.Tensor:
    """Associated-Legendre-recurrence SH oracle in float64 torch (independent
    of the jnp implementation's Cartesian generation; reference oracle
    testing/test_shencoder.py:8-50)."""
    import math

    x, y, z = (d[:, i].to(torch.float64) for i in range(3))
    B = d.shape[0]
    # azimuthal parts: C_m + i S_m = (x + iy)^m
    Cm = [torch.ones(B, dtype=torch.float64)]
    Sm = [torch.zeros(B, dtype=torch.float64)]
    for m in range(1, degree):
        Cm.append(Cm[-1] * x - Sm[-1] * y)
        Sm.append(Sm[-1] * x + Cm[-2] * y)
    out = torch.zeros(B, degree * degree, dtype=torch.float64)
    for m in range(degree):
        # Pbar with sin^m folded: Pb_m^m = (-1)^m (2m-1)!!
        pmm = ((-1.0) ** m) * float(np.prod(np.arange(1, 2 * m, 2))) if m > 0 else 1.0
        P = [torch.full((B,), pmm, dtype=torch.float64)]
        if m + 1 < degree:
            P.append((2 * m + 1) * z * P[0])
        for l in range(m + 2, degree):
            P.append(((2 * l - 1) * z * P[-1] - (l + m - 1) * P[-2]) / (l - m))
        for i, l in enumerate(range(m, degree)):
            K = math.sqrt(
                (2 * l + 1) / (4 * math.pi)
                * math.factorial(l - m) / math.factorial(l + m)
            )
            if m == 0:
                out[:, l * l + l] = K * P[i]
            else:
                out[:, l * l + l + m] = math.sqrt(2.0) * K * Cm[m] * P[i]
                out[:, l * l + l - m] = math.sqrt(2.0) * K * Sm[m] * P[i]
    return out


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 6, 8])
def test_sh_vs_torch_oracle(degree):
    rng = np.random.default_rng(3)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ours = np.asarray(sh_encode_cf(jnp.asarray(d).T, degree)).T
    theirs = torch_sh_oracle(torch.from_numpy(d), degree).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------------ compositing
# ----------------------------------------------- end-to-end uniform render path
class _TinyField:
    """Shared-weight toy field: sigma = trunc_exp(w2 @ relu(w1 @ x)),
    rgb = sigmoid(w3 @ relu(w1 @ x)); evaluated in both frameworks."""

    def __init__(self, seed=5):
        rng = np.random.default_rng(seed)
        self.w1 = rng.normal(0, 0.5, (3, 16)).astype(np.float32)
        self.w2 = rng.normal(0, 0.5, (16, 1)).astype(np.float32)
        self.w3 = rng.normal(0, 0.5, (16, 3)).astype(np.float32)

    def params_jax(self):
        return {"w1": jnp.asarray(self.w1), "w2": jnp.asarray(self.w2),
                "w3": jnp.asarray(self.w3)}

    @staticmethod
    def field_fns():
        from tngp.render import FieldFns

        def density(p, x_cf):
            h = jax.nn.relu(p["w1"].T @ x_cf)
            return jnp.exp(jnp.clip(p["w2"].T @ h, -15, 15))[0]

        def sigma_rgb(p, x_cf, d_cf):
            h = jax.nn.relu(p["w1"].T @ x_cf)
            sigma = jnp.exp(jnp.clip(p["w2"].T @ h, -15, 15))[0]
            rgb = jax.nn.sigmoid(p["w3"].T @ h)
            return sigma, rgb

        return FieldFns(sigma_rgb=sigma_rgb, density=density)

    def torch_eval(self, pts):  # pts [M, 3]
        h = torch.relu(pts @ self.tw1)
        sigma = torch.exp(torch.clamp(h @ self.tw2, -15, 15))[:, 0]
        rgb = torch.sigmoid(h @ self.tw3)
        return sigma, rgb

    def torch_params(self):
        self.tw1 = torch.from_numpy(self.w1.copy()).requires_grad_(True)
        self.tw2 = torch.from_numpy(self.w2.copy()).requires_grad_(True)
        self.tw3 = torch.from_numpy(self.w3.copy()).requires_grad_(True)
        return [self.tw1, self.tw2, self.tw3]
