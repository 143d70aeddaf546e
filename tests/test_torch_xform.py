"""Host-side checks of the tiled dense products (``csrc/xnor.cuh``):
``bmm_xnor`` (``csrc/bmm.cu``) and the fused layer's transform phase
(``csrc/fused_layer.cu``). Their launchers work out tiles, shared memory
and grids on the card; here, without one:

* the mma route's arithmetic written out with plain PyTorch ops: K padded
  with zero words to 256-bit steps, AND-popc per step, and ``n_bits - 2
  (popc a + popc b) + 4 sum popc(a & b)``, against the reference
  ``bmm_xnor`` (Pallas in interpret mode) at K in {7, 255, 256, 257, 500}
  and N in {1, 7, 8, 33, 64}, counts and sign words, bit-exact;
* the ctypes side of the C interface: each library's exported functions
  against ``build.SIGNATURES`` and the fused layer's ``Params`` struct
  against ``fused_layer._Params``, read from the sources, so that a drift
  between the two languages shows without a card;
* the CUDA wrappers refuse tensors they have no kernel for.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import bmm_kernel as jbk  # noqa: E402
bitops = lazy("repro_torch.core.bitops")
bmm_kernel = lazy("repro_torch.kernels.bmm_kernel")
build = lazy("repro_torch.kernels.build")
fused_layer = lazy("repro_torch.kernels.fused_layer")

jax.config.update("jax_platform_name", "cpu")

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _zero_pad(t, multiple):
    pad = -(-t.shape[1] // multiple) * multiple - t.shape[1]
    return torch.cat([t, t.new_zeros((t.shape[0], pad))], 1)


def _and_popc_mirror(a, b, n_bits, binarize):
    """Route mma's arithmetic: zero words up to 256-bit steps, AND-popc a
    step at a time, then the XOR count from the row and column popcounts."""
    a, b = _zero_pad(a, 8), _zero_pad(b, 8)
    pa = bitops.popcount(bitops.as_u32(a)).sum(1)
    pb = bitops.popcount(bitops.as_u32(b)).sum(1)
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64)
    for s in range(0, a.shape[1], 8):
        for w in range(s, s + 8):
            acc += bitops.popcount(bitops.as_u32(a[:, w, None] & b[None, :, w]))
    out = (n_bits - 2 * (pa[:, None] + pb[None, :]) + 4 * acc).to(torch.int32)
    return bitops.pack_bits(out >= 0, axis=-1) if binarize else out


@pytest.mark.parametrize("binarize", [False, True], ids=["counts", "words"])
def test_and_popc_identity_matches_reference(binarize):
    rng = np.random.default_rng(14 + binarize)
    for k in (7, 255, 256, 257, 500):
        for n in (1, 7, 8, 33, 64):
            a = bitops.pack_bits(torch.from_numpy(rng.integers(0, 2, (37, k))))
            b = bitops.pack_bits(torch.from_numpy(rng.integers(0, 2, (n, k))))
            got = _and_popc_mirror(a, b, k, binarize)
            want = np.asarray(jbk.bmm_xnor(
                jnp.asarray(a.numpy().view(np.uint32)),
                jnp.asarray(b.numpy().view(np.uint32)), k, binarize,
                interpret=True)).view(np.int32)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{k} {n}")
            assert torch.equal(got, bmm_kernel.bmm_xnor_plain(a, b, k, binarize))


def _ctype(decl: str):
    """The ctypes type of a C parameter or field declaration."""
    if "*" in decl:
        return build._P
    return build._L if "long long" in decl else build._I


@pytest.mark.parametrize("source", ["pack", "bmm", "bspmm", "bspmm_grid",
                                    "fused_layer", "fused_pair"])
def test_signatures_match_sources(source):
    """Every ``extern "C"`` function of a source, and nothing else, is in
    ``build.SIGNATURES`` with its parameters' types in order."""
    text = (CSRC / f"{source}.cu").read_text()
    found = {name: tuple(_ctype(p) for p in params.split(","))
             for name, params in re.findall(
                 r'extern "C" int (\w+)\(([^)]*)\)', text)}
    assert found == build.SIGNATURES[source]


def test_fused_params_mirror_struct():
    """``fused_layer._Params`` has the fields of ``Params`` in
    ``csrc/fused_layer.cu``, in order, with the same types."""
    text = (CSRC / "fused_layer.cu").read_text()
    body = re.search(r"struct Params \{(.*?)\n\};", text, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if decl:
            fields.append((re.match(r".*?(\w+);$", decl).group(1),
                           _ctype(decl)))
    assert fields == list(fused_layer._Params._fields_)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor ``bmm_xnor``'s CUDA wrapper raises: it never runs the
    plain version (dispatch by device is ops' job). The fused layer's device
    check sends CPU tensors to the plain versions and refuses devices it
    has no kernels for."""
    a = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bmm_kernel.bmm_xnor_cuda(a, a, 64)
    with pytest.raises(RuntimeError, match="no kernels for device"):
        fused_layer._on_card(torch.zeros(1, device="meta"))
    assert not fused_layer._on_card(torch.zeros(1))
