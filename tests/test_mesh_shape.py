"""Grid-aware device-mesh factorization (parallel.pick_mesh_shape).

The auto mesh shape minimizes the local block's halo perimeter over the
factorizations that divide the grid, splitting the leading axis on ties.
"""

from __future__ import annotations

import jax
import pytest

from nextsimdg_tpu.parallel import make_spatial_mesh, pick_mesh_shape


def local_shape(n, nx, ny):
    px, py = pick_mesh_shape(n, nx, ny)
    assert px * py == n
    assert nx % px == 0 and ny % py == 0
    return nx // px, ny // py


def test_wide_lane_grid_splits_lanes_first():
    # 1024 x 16384: (1, 8) -> 1024 x 2048 has the smallest perimeter.
    assert local_shape(8, 1024, 16384) == (1024, 2048)


def test_tall_grid_splits_sublanes_first():
    # The transpose: (8, 1) -> 2048 x 1024.
    assert local_shape(8, 16384, 1024) == (2048, 1024)


def test_square_16m_grid_keeps_local_lanes_in_the_good_band():
    # 4096^2 over 8 devices: (2,4) and (4,2) tie on perimeter; the tie
    # splits the leading axis further. 4096-wide locals never win.
    assert local_shape(8, 4096, 4096) == (1024, 2048)
    assert pick_mesh_shape(4, 4096, 4096) == (2, 2)


def test_two_devices_split_the_lane_axis():
    # A lane-wide grid: (1, 2) -> 1024 x 2048 beats (2, 1) -> 512 x 4096.
    assert pick_mesh_shape(2, 1024, 4096) == (1, 2)
    # On 4096^2 (1,2) and (2,1) have equal perimeters; the tie splits X,
    # whose halo strips are contiguous rows.
    assert pick_mesh_shape(2, 4096, 4096) == (2, 1)


def test_indivisible_grid_falls_back_to_squarest():
    # Nothing divides 101 x 103 -> squarest factorization for GSPMD.
    assert pick_mesh_shape(8, 101, 103) == (2, 4)


def test_single_device():
    assert pick_mesh_shape(1, 256, 256) == (1, 1)


def test_make_spatial_mesh_grid_aware_and_explicit_override():
    n = jax.device_count()
    mesh = make_spatial_mesh(grid_shape=(1024, 1024 * n))
    assert mesh.devices.size == n
    # The wide-lane grid pushes the split onto Y.
    assert mesh.shape["Y"] >= mesh.shape["X"]
    # An explicit shape always wins over grid_shape.
    if n % 2 == 0:
        forced = make_spatial_mesh((n // 2, 2), grid_shape=(1024, 1024 * n))
        assert forced.shape["X"] == n // 2 and forced.shape["Y"] == 2


def test_coupled_cli_shardmap_auto_shape_matches_single(tmp_path, monkeypatch):
    """mode=shardmap with NO mesh_shape uses the grid-aware factorization
    end-to-end and still reproduces the single-device run."""
    import shutil

    import numpy as np

    from nextsimdg_tpu.config import Configurator
    from nextsimdg_tpu.modules import ModuleRegistry
    from nextsimdg_tpu.runtime.coupled_main import run_coupled
    from tests.test_coupled_main import write_cfg
    from nextsimdg_tpu.io.coupled_restart import load_coupled_state

    monkeypatch.chdir(tmp_path)
    cfg = write_cfg(tmp_path, extra="[parallel]\nmode = single\n")
    assert run_coupled(["prog", "--config-file", cfg]) == 0
    shutil.move("coupled_restart.chk", "single.chk")

    Configurator.clear()
    ModuleRegistry.get_loader().reset()
    cfg = write_cfg(
        tmp_path,
        extra=(
            "[parallel]\nmode = shardmap\n"  # mesh_shape intentionally unset
            "mevp_backend = blocked\nmevp_block_halo = 4\n"
        ),
    )
    assert run_coupled(["prog", "--config-file", cfg]) == 0

    a = load_coupled_state("single.chk")
    b = load_coupled_state("coupled_restart.chk")
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(
            np.asarray(x), np.asarray(y), rtol=2e-5, atol=1e-7
        )


@pytest.mark.parametrize(
    "n,nx,ny",
    [(4, 4096, 4096), (4, 2048, 8192), (8, 1024, 3072), (6, 960, 640)],
)
def test_pick_minimizes_the_halo_perimeter(n, nx, ny):
    """No divisible factorization has a smaller local-block perimeter."""
    px, py = pick_mesh_shape(n, nx, ny)
    best = min(
        nx // a + ny // (n // a)
        for a in range(1, n + 1)
        if n % a == 0 and nx % a == 0 and ny % (n // a) == 0
    )
    assert nx // px + ny // py == best
