"""Platform helpers: backend choice, the accelerator, the compile cache.

``use_cpu`` and ``require_gpu`` must be called before the first JAX
computation (backend initialisation is sticky).
"""

from __future__ import annotations

import os

# <repo>/.jax_cache: a fixed path (the cache key includes it), listed in
# .gitignore
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def use_cpu(x64: bool = True, virtual_devices: int = 0) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    if virtual_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={virtual_devices}"
        )
    import jax
    jax.config.update("jax_platforms", "cpu")
    if x64:
        jax.config.update("jax_enable_x64", True)


def select_device():
    """The first device of JAX's default backend when that backend is a
    GPU, else None.  With a GPU, float32 contractions are set to full
    precision for the whole process: XLA:GPU otherwise runs them in TF32
    (about three decimal digits), which the CG dot products and the Kelly
    marking cannot tolerate."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        return None
    jax.config.update("jax_default_matmul_precision", "highest")
    return dev


def require_gpu():
    """The first GPU device; raises RuntimeError when JAX's default backend
    is not a GPU (the measurement entry points never fall back to the
    CPU)."""
    dev = select_device()
    if dev is None:
        import jax
        raise RuntimeError(
            f"JAX found no GPU (default backend: "
            f"{jax.devices()[0].platform}); this entry point runs on the "
            f"card only")
    return dev


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory.  ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX
    itself and no path is set here; otherwise the cache is
    ``<repo>/.jax_cache``."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def init_distributed(coordinator: str = None, num_processes: int = None,
                     process_id: int = None) -> None:
    """Initialize ``jax.distributed`` for multi-process device meshes.

    The analogue of the reference's ``MPI_InitFinalize`` (src/main.cc:8):
    after this, ``jax.devices()`` spans every process's devices and the
    sharded solvers' collectives (parallel/sharded*.py) run across all of
    them.  Without a cluster environment, pass the coordinator address
    (``host:port``), the process count and this process's id; call before
    any other JAX computation.  No-op if already initialized.
    """
    import jax
    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:
        if "already initialized" not in str(e).lower():
            raise
