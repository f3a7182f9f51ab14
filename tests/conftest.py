"""Test configuration: force the CPU backend with 8 virtual devices so
multi-device sharding tests run anywhere (SURVEY.md §4). Must run before the
first jax import. Tests that need a GPU carry the ``gpu`` marker and the
``gpu`` fixture, which skips them where JAX finds none."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Also through jax.config, in case a plugin imported jax before this file.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", jax.devices()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# XLA:CPU's compiler has segfaulted mid-suite on single-CPU boxes after
# a few hundred accumulated compilations (observed twice at the ~85%
# mark, in whatever module sat there; each module passes in isolation).
# Both mitigations are cheap: a deeper main-thread stack for the
# compiler's recursive passes, and dropping compiled executables between
# modules so per-process compiler state stays bounded.
try:  # not available on non-POSIX
    import resource

    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    if _soft != resource.RLIM_INFINITY and (
            _hard == resource.RLIM_INFINITY or _hard > _soft):
        resource.setrlimit(resource.RLIMIT_STACK,
                           (min(_hard, 512 << 20) if _hard
                            != resource.RLIM_INFINITY
                            else resource.RLIM_INFINITY, _hard))
except Exception:
    pass

_last_module = [None]


@pytest.fixture(autouse=True, scope="session")
def _no_compile_cache_in_test_processes():
    """Entry points called in-process (cli.main, __graft_entry__,
    chip_smoke.main) place JAX's persistent compile cache; test processes
    keep compiling in memory only, and write nothing into the checkout.
    tests/test_device.py checks the real helper in child processes."""
    from pathtracer_tpu import device
    real = device.setup_compile_cache
    device.setup_compile_cache = lambda: "(not set in tests)"
    yield
    device.setup_compile_cache = real


@pytest.fixture
def gpu():
    """Skip unless JAX finds a GPU; decided here, never at import."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX platform is "
                    f"{jax.devices()[0].platform}")


@pytest.fixture(autouse=True)
def _clear_jax_caches_between_modules(request):
    mod = request.module.__name__
    if _last_module[0] is not None and _last_module[0] != mod:
        jax.clear_caches()
    _last_module[0] = mod
    yield


# The fast tier (`pytest -m smoke`, VERDICT round 3 item 9): one (or a
# few) representative tests per subsystem, curated here centrally so the
# inner loop has a < 5-minute gate and the 35-40 min full suite stops
# being the only option. Keep this list to tests that finish in seconds.
SMOKE_TESTS = {
    # RNG keystone + color + oracle twin
    "test_math.py::TestPrng::test_deterministic_and_batch_invariant",
    "test_math.py::TestOraclePrngTwin::test_all_streams_bit_identical",
    "test_math.py::TestColor::test_linear_to_srgb_exact",
    # sampling / BSDF
    "test_sampling.py::TestPdfs::test_pdf_cosine",
    "test_sampling.py::TestBsdf::test_refraction_tir",
    # intersectors + dispatch
    "test_intersect.py::TestSceneDispatch::test_nearest_hit_and_miss",
    # golden gate (the correctness keystone)
    "test_golden.py::TestGolden::test_world_cornell",
    # material lookup forms + flat texture fetch
    "test_material_lookup.py::test_sweep_equals_gather[17]",
    "test_texture_fetch.py::test_combined_fetch_matches_oracle_sampler",
    # sharding + driver entry
    "test_parallel.py::TestSharded::test_sharded_matches_single",
    "test_parallel.py::TestGraftEntry::test_dryrun_multichip[4]",
    # CLI / IO / worlds
    "test_cli.py::TestReferenceFlags::test_concatenated_flags",
    "test_io.py::TestBmp::test_roundtrip",
    "test_io.py::TestGltf::test_parse_glb",
    "test_worlds.py::TestWorlds::test_cornell_layout",
    # acceleration structure + device helper
    "test_accel.py::TestTraversal::test_grid_matches_brute_force",
    "test_device.py::test_record_fields",
    # native tool
    "test_native.py::TestNativeCompare::test_similarity_matches_python",
    # renderer plumbing: checkpoint/resume
    "test_renderer.py::TestCheckpoint::test_resume_is_exact",
    # wavefront driver
    "test_wavefront.py::TestWavefrontEquivalence::test_cornell_identical",
    # beyond-reference features (one cheap gate each)
    "test_refraction.py::TestRefractNp::test_total_internal_reflection",
    "test_fog.py::TestFogRenderer::test_pure_absorption_transmittance",
    "test_tbn.py::TestTBN::test_identity_map_preserves_geometry",
    "test_bump.py::TestBump::test_flat_height_leaves_normal",
    "test_mips.py::TestMipSampling::test_lod0_bit_equal_to_mip0",
    "test_mesh_uv.py::TestGltfTextured::test_loader_binds_texture_and_uvs",
    "test_denoise.py::TestAtrous::test_reduces_noise_preserves_edges",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        rel = item.nodeid.split("/")[-1]  # conftest sits in tests/
        if rel in SMOKE_TESTS:
            item.add_marker(pytest.mark.smoke)


def pytest_configure(config):
    """Build the native library when a toolchain exists, so test_native.py
    only skips where it truly can't build (VERDICT round 1, weak #7). A
    failed build falls through to the existing skip markers."""
    import shutil
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if shutil.which("make") and shutil.which("g++"):
        subprocess.run(
            ["make", "-C", os.path.join(repo, "native")],
            capture_output=True, timeout=300, check=False,
        )


@pytest.fixture
def rng():
    return np.random.RandomState(42)
