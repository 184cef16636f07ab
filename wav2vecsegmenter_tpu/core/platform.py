"""The one module that asks which machine this process runs on.

Everything that differs between the GPU and the CPU is decided here: the
compute dtype, the attention implementation, the train-loop defaults and
the persistent compile cache.  No other module calls
``jax.default_backend()``.

The GPU is the production target.  The CPU runs the tests (float32, plain
XLA attention); nothing here drops an accelerator run to the CPU —
:func:`require_gpu` fails instead.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax
import jax.numpy as jnp

REPO_ROOT = Path(__file__).resolve().parents[2]
# fixed path inside the checkout: the path is part of the cache key, so a
# directory that moved between runs would never hit
CACHE_DIR = REPO_ROOT / ".jax_cache"


def backend() -> str:
    return jax.default_backend()


def on_gpu() -> bool:
    return backend() == "gpu"


def require_gpu() -> list:
    """The GPU devices, or an error: an accelerator run never falls back to
    the CPU."""
    devices = jax.devices()
    if not devices or devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU found (JAX devices: {devices}); this run needs one")
    return devices


def compute_dtype(requested: str = "bfloat16"):
    """bf16 on the GPU unless float32 is asked for; float32 on the CPU,
    where bf16 is slow and only the tests run."""
    if requested not in ("bfloat16", "float32"):
        raise ValueError(f"unknown compute dtype '{requested}'")
    if requested == "bfloat16" and on_gpu():
        return jnp.bfloat16
    return jnp.float32


def attention_impl(dtype) -> str:
    """'cudnn' (cuDNN fused flash attention, bf16/fp16 only) on the GPU;
    'xla' (the plain einsum reference) on the CPU and for float32."""
    low = jnp.dtype(dtype) in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16))
    return "cudnn" if on_gpu() and low else "xla"


def device_normalize_default() -> bool:
    """Upload raw int16 audio and normalize on the device: halves the
    host->device bytes, which on the GPU cross PCIe.  The CPU tests keep
    host normalization (bit-parity with the reference's numpy path)."""
    return on_gpu()


def setup_compilation_cache() -> None:
    """Persistent XLA compile cache.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads it itself and no other
    directory is set here.  Otherwise the GPU caches in ``<repo>/.jax_cache``.
    CPU runs do not cache: CPU AOT entries embed the host's machine features
    and can crash (SIGILL) when loaded on another host.
    """
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        if not on_gpu():
            return
        CACHE_DIR.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
