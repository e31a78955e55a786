"""TextDS: on-demand SA/ISA/Phi/PLCP/LCP over a sentinel-terminated text.

Mirror of include/tudocomp/ds/TextDS.hpp:30-344 (require() builds providers
in dependency order) with array providers:
  SA    C++ SA-IS, or prefix doubling on the device (ds/suffix_array.py)
  Phi   phi[sa[i]] = sa[i-1]              (ds/PhiFromSA.hpp:37-45)
  PLCP  Kärkkäinen phi-algorithm           (ds/PLCPFromPhi.hpp:38-44)
  LCP   LCP[i] = PLCP[sa[i]]               (ds/LCPFromPLCP.hpp:38-49)
        (both on the device, ops/plcp_torch.py, where the device built the SA)
  ISA   inverse permutation                (ds/ISAFromSA.hpp:12-61)
The BWT (ds/bwt.hpp) is a gather of the text at SA - 1: on the device where
the device built the SA (TextDS.bwt), else on the host; its decode (the LF
walk) stays on the host. The CompressMode bit-packing axis of the reference collapses to numpy
dtypes (arrays are i32); requires a text whose last byte is the unique 0
sentinel, as guaranteed by Meta.uses_textds input restrictions. The port's
copy of tudocomp_tpu/ds/textds.py: the arrays it hands out are numpy arrays
on the host, whichever device built them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import native
from ..device import use_sa_device
from ..stats.phase import StatPhase
from . import flags
from .suffix_array import (
    inverse_permutation,
    lcp_from_plcp,
    phi_from_sa,
    plcp_from_phi_numpy,
    suffix_array_numpy,
)


class TextDS:
    def __init__(
        self,
        text: np.ndarray,
        device="cpu",
        lcp_provider: str = "from_phi",
        isa_provider: str = "from_sa",
        sparse_isa_t: int = 3,
        compress_mode: str = "plain",
    ):
        self.text = np.ascontiguousarray(text, dtype=np.uint8)
        self.device = torch.device(device)  # where the device SA runs
        # provider selection (the `textds` DSL axis, ds/textds_algo.py):
        # "compressed_lcp" answers LCP through a Sada bitvector + Select,
        # "sparse_isa" answers ISA through cycle shortcuts + Rank
        self.lcp_provider = lcp_provider
        self.isa_provider = isa_provider
        self.sparse_isa_t = sparse_isa_t
        # CompressMode (ds/CompressMode.hpp + TextDS.hpp:247-292):
        # "plain" retains full-width numpy arrays; "compressed" bit-packs
        # each DS to bits_for(n) right after construction; "delayed" /
        # "coherent_delayed" pack everything at the end of a bulk
        # require(). Packed arrays are the RESIDENT form — getters hand
        # out transient full-width copies so the native/numpy consumers
        # keep their contiguous-int32 fast paths.
        assert compress_mode in (
            "plain", "delayed", "compressed", "coherent_delayed",
        ), compress_mode
        self.compress_mode = compress_mode
        self._sa: Optional[np.ndarray] = None
        self._isa: Optional[np.ndarray] = None
        self._phi: Optional[np.ndarray] = None
        self._plcp: Optional[np.ndarray] = None
        self._lcp: Optional[np.ndarray] = None
        # the text, the SA and its ranks (the ISA, for free) on the device,
        # left there by a device SA for the PLCP and the LCP to be computed
        # where they lie, for require_isa and for device_arrays
        self._text_d = self._sa_d = self._isa_d = self._plcp_d = None

    def __len__(self) -> int:
        return len(self.text)

    def require(self, what: int) -> None:
        if what & flags.SA:
            self.require_sa()
        if what & flags.PHI:
            self.require_phi()
        if what & flags.PLCP:
            self.require_plcp()
        if what & flags.LCP:
            self.require_lcp()
        if what & flags.ISA:
            self.require_isa()
        if self.compress_mode in ("delayed", "coherent_delayed"):
            self.bit_compress()

    # -- CompressMode plumbing ------------------------------------------------

    def _maybe_pack(self, arr):
        """In "compressed" mode, return the bit-packed resident form."""
        if self.compress_mode != "compressed" or arr is None:
            return arr
        return self._pack_one(arr)

    def _pack_one(self, arr):
        from .int_vector import IntVector, bits_for

        if not isinstance(arr, np.ndarray) or len(arr) == 0:
            return arr
        return IntVector(
            arr.astype(np.int64), width=bits_for(max(1, len(self.text)))
        )

    @staticmethod
    def _unpack(arr):
        from .int_vector import IntVector

        if isinstance(arr, IntVector):
            return arr.to_array().astype(np.int32)
        return arr

    def bit_compress(self) -> None:
        """Bit-pack every constructed DS to bits_for(n) width — the
        delayed CompressMode sweep (TextDS.hpp:285-291)."""
        for name in ("_sa", "_isa", "_phi", "_plcp", "_lcp"):
            cur = getattr(self, name)
            if isinstance(cur, np.ndarray):
                setattr(self, name, self._pack_one(cur))

    # -- providers ------------------------------------------------------------

    def require_sa(self) -> np.ndarray:
        if self._sa is None:
            with StatPhase("Construct SA") as ph:
                lib = native.get_lib()
                n = len(self.text)
                if n and use_sa_device(n, self.device):
                    # prefix doubling on the device (suffix_array_device);
                    # its final ranks are the ISA, kept on the device until
                    # require_isa asks for them
                    from .suffix_array import suffix_array_device

                    self._text_d = torch.from_numpy(self.text).to(self.device)
                    sa_d, isa_d = suffix_array_device(self._text_d, return_isa=True)
                    self._sa_d, self._isa_d = sa_d, isa_d
                    self._sa = sa_d.cpu().numpy()
                elif lib is not None and hasattr(lib, "tdc_sais") and n:
                    sa = np.empty(n, dtype=np.int32)
                    rc = lib.tdc_sais(self.text, n, sa)
                    assert rc == 0, "native SA-IS failed"
                    self._sa = sa
                else:
                    self._sa = suffix_array_numpy(self.text)
                ph.log("n", n)
                from ..paranoid import check_permutation

                check_permutation(self._sa, n, "SA")
                self._sa = self._maybe_pack(self._sa)
        return self._unpack(self._sa)

    def require_isa(self) -> np.ndarray:
        if self._isa is None:
            with StatPhase("Construct ISA") as ph:
                if self.isa_provider == "sparse_isa" and len(self.text):
                    from .providers import SparseISA

                    s = SparseISA(self.require_sa(), t=max(1, self.sparse_isa_t))
                    ph.log("provider", "sparse_isa")
                    self._isa = s.to_array_via_queries().astype(np.int32)
                elif self._isa_d is not None:
                    # the staged device SA's head-rank array IS the ISA
                    self._isa = self._isa_d.cpu().numpy()
                    ph.log("provider", "device_sa_ranks")
                else:
                    self._isa = inverse_permutation(self.require_sa())
                self._isa = self._maybe_pack(self._isa)
        return self._unpack(self._isa)

    def require_phi(self) -> np.ndarray:
        if self._phi is None:
            with StatPhase("Construct Phi Array"):
                self._phi = self._maybe_pack(phi_from_sa(self.require_sa()))
        return self._unpack(self._phi)

    def _plcp_device(self) -> torch.Tensor:
        """The PLCP on the device, from the SA that the device built."""
        if self._plcp_d is None:
            from ..ops.plcp_torch import plcp_device

            self._plcp_d = plcp_device(self._text_d, self._sa_d)
        return self._plcp_d

    def device_arrays(self):
        """(SA, ISA, PLCP) as int32 tensors on the device, where the device
        built the SA and the ISA is its ranks (isa_provider "from_sa"): the
        PLCP comes from kernel H, and nothing but the SA (require_sa's) goes
        to the host. None where the host built the SA."""
        self.require_sa()
        if self._sa_d is None or self.isa_provider != "from_sa":
            return None
        return self._sa_d, self._isa_d, self._plcp_device()

    def require_plcp(self) -> np.ndarray:
        if self._plcp is None:
            phi = None if self._sa_d is not None else self.require_phi()
            with StatPhase("Construct PLCP Array") as ph:
                lib = native.get_lib()
                n = len(self.text)
                if self._sa_d is not None:
                    self._plcp = self._plcp_device().cpu().numpy()
                    ph.log("provider", "device_plcp")
                elif lib is not None and hasattr(lib, "tdc_plcp_from_phi") and n:
                    plcp = np.empty(n, dtype=np.int32)
                    lib.tdc_plcp_from_phi(self.text, n, phi, plcp)
                    self._plcp = plcp
                else:
                    self._plcp = plcp_from_phi_numpy(self.text, phi)
                self._plcp = self._maybe_pack(self._plcp)
        return self._unpack(self._plcp)

    def require_lcp(self) -> np.ndarray:
        if self._lcp is None:
            with StatPhase("Construct LCP Array") as ph:
                if self.lcp_provider == "compressed_lcp" and len(self.text):
                    from .providers import CompressedLCP

                    c = CompressedLCP(self.require_plcp())
                    ph.log("provider", "compressed_lcp")
                    # materialize through the Select-answered bitvector
                    self._lcp = lcp_from_plcp(
                        c.plcp_array(), self.require_sa()
                    ).astype(np.int32)
                elif self._sa_d is not None and self._plcp is None:
                    # SA and text lie on the device: PLCP and LCP there too,
                    # only the LCP comes back
                    from ..ops.plcp_torch import lcp_from_plcp_device

                    lcp_d = lcp_from_plcp_device(self._plcp_device(), self._sa_d)
                    self._lcp = lcp_d.cpu().numpy()
                    ph.log("provider", "device_plcp")
                else:
                    self._lcp = lcp_from_plcp(
                        self.require_plcp(), self.require_sa()
                    )
                self._lcp = self._maybe_pack(self._lcp)
        return self._unpack(self._lcp)

    def bwt(self) -> np.ndarray:
        """The BWT of the text (bwt_from_sa): the gather runs on the device
        where the device built the SA, and the n bytes come back; else on
        the host."""
        sa = self.require_sa()
        if self._sa_d is not None:
            return bwt_from_sa(self._text_d, self._sa_d)
        return bwt_from_sa(self.text, sa)

    # accessors mirroring TextDS::sa()/isa()/... ------------------------------

    def sa(self) -> np.ndarray:
        assert self._sa is not None
        return self._unpack(self._sa)

    def isa(self) -> np.ndarray:
        assert self._isa is not None
        return self._unpack(self._isa)

    def phi(self) -> np.ndarray:
        assert self._phi is not None
        return self._unpack(self._phi)

    def plcp(self) -> np.ndarray:
        assert self._plcp is not None
        return self._unpack(self._plcp)

    def lcp(self) -> np.ndarray:
        assert self._lcp is not None
        return self._unpack(self._lcp)


def bwt_from_sa(text, sa) -> np.ndarray:
    """bwt[i] = text[sa[i]-1] (text[n-1] when sa[i]==0), ds/bwt.hpp:20-23.

    numpy arrays: on the host. Tensors (a uint8 text and an int32 SA on one
    device): the gather runs there and the n bytes come back."""
    if isinstance(sa, torch.Tensor):
        idx = torch.remainder(sa - 1, text.numel())
        return torch.index_select(text, 0, idx).cpu().numpy()
    text = np.asarray(text, dtype=np.uint8)
    return text[(sa.astype(np.int64) - 1) % len(text)]


def bwt_lf(bwt: np.ndarray) -> np.ndarray:
    """LF mapping: LF[i] = rank of (bwt[i], i) in (char, pos) order
    (ds/bwt.hpp:29-66)."""
    n = len(bwt)
    order = np.argsort(bwt, kind="stable")
    lf = np.empty(n, dtype=np.int64)
    lf[order] = np.arange(n, dtype=np.int64)
    return lf


def decode_bwt(bwt: np.ndarray) -> np.ndarray:
    """LF-walk reconstruction, dropping the sentinel (ds/bwt.hpp:77-98).

    Returns the original text (length n-1) for a BWT of a 0-terminated text.
    """
    bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
    n = len(bwt)
    if n <= 1:
        return np.zeros(0, dtype=np.uint8)
    lf = bwt_lf(bwt)
    from ..paranoid import check_permutation

    check_permutation(lf, n, "LF")
    lib = native.get_lib()
    out = np.empty(n - 1, dtype=np.uint8)
    if lib is not None:
        lib.tdc_bwt_walk(bwt, lf, n, out)
        return out
    i = 0
    for j in range(1, n):
        out[n - 1 - j] = bwt[i]
        i = lf[i]
    return out
