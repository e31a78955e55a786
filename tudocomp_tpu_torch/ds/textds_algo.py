"""The DSL-selectable `textds` sub-algorithm axis. The port's copy of
tudocomp_tpu/ds/textds_algo.py.

Mirror of the reference's TextDS registration: bwt/lzss_lcp/lcpcomp take a
``textds(sa=..., phi=..., plcp=..., lcp=..., isa=...)`` sub-algorithm option
selecting the construction providers (ds/TextDS.hpp:118-124;
etc/registry_config.py:42-75, 227, 238). Provider ids match the reference:

  sa   = divsufsort                      (ds/SADivSufSort.hpp:16; here the
                                          construction is native SA-IS /
                                          device prefix doubling — the id is
                                          kept for DSL compatibility)
  phi  = from_sa                         (ds/PhiFromSA.hpp:15)
  plcp = from_phi                        (ds/PLCPFromPhi.hpp:18)
  lcp  = from_phi | compressed_lcp       (ds/LCPFromPLCP.hpp:18,
                                          ds/CompressedLCP.hpp:32)
  isa  = from_sa | sparse_isa            (ds/ISAFromSA.hpp:15,
                                          ds/SparseISA.hpp:31)

The succinct providers (ds/providers.py) construct their compressed
structures and answer through them (Select for compressed_lcp, shortcut +
Rank queries for sparse_isa); the resulting arrays feed the compressors
unchanged, so every coder/format stays bit-identical across the axis.

Unlike the reference, lcpcomp accepts ``lcp=compressed_lcp`` too: the
reference restricts lcpcomp to writable LCP arrays
(etc/registry_config.py:158 lcp_uncompressed) because its CompressedLCP
cannot be mutated in place, but here every provider materializes to a
mutable numpy array before the strategy runs.
"""

from __future__ import annotations

from ..meta import Algorithm, Meta


class SADivSufSort(Algorithm):
    @classmethod
    def meta(cls) -> Meta:
        return Meta("sa", "divsufsort", "Suffix array (native SA-IS / device prefix doubling)")


class PhiFromSA(Algorithm):
    @classmethod
    def meta(cls) -> Meta:
        return Meta("phi", "from_sa", "Phi array from the suffix array")


class PLCPFromPhi(Algorithm):
    @classmethod
    def meta(cls) -> Meta:
        return Meta("plcp", "from_phi", "PLCP via the Karkkainen phi-algorithm")


class LCPFromPLCP(Algorithm):
    @classmethod
    def meta(cls) -> Meta:
        return Meta("lcp", "from_phi", "LCP[i] = PLCP[sa[i]]")


class CompressedLCPProvider(Algorithm):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta(
            "lcp",
            "compressed_lcp",
            "LCP via Sada-style 2n-bit unary-delta PLCP bitvector + Select",
        )
        m.option("sa").templated("sa", "divsufsort")
        return m


class ISAFromSA(Algorithm):
    @classmethod
    def meta(cls) -> Meta:
        return Meta("isa", "from_sa", "ISA as the inverse permutation of SA")


class SparseISAProvider(Algorithm):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta(
            "isa",
            "sparse_isa",
            "Sampled ISA: SA-cycle shortcuts + Rank (ds/SparseISA.hpp)",
        )
        m.option("sa").templated("sa", "divsufsort")
        m.option("t").dynamic(3)
        return m


class TextDSAlgo(Algorithm):
    """The `textds` selection bundle handed to compressors as a sub-algorithm.

    `create(text)` builds a ds.textds.TextDS routed through the selected
    providers (TextDS.hpp:158-172 require_* semantics).
    """

    @classmethod
    def meta(cls) -> Meta:
        m = Meta("textds", "textds", "Text data structure provider selection")
        m.option("sa").templated("sa", "divsufsort")
        m.option("phi").templated("phi", "from_sa")
        m.option("plcp").templated("plcp", "from_phi")
        m.option("lcp").templated("lcp", "from_phi")
        m.option("isa").templated("isa", "from_sa")
        # CompressMode (ds/CompressMode.hpp): plain | delayed | compressed
        # | coherent_delayed — resident DS arrays bit-packed to bits_for(n)
        # per the selected schedule (TextDS.hpp:247-292)
        m.option("cm").dynamic("plain")
        return m

    def create(self, text):
        from .textds import TextDS

        lcp_av = self.env.option("lcp").as_algorithm()
        isa_av = self.env.option("isa").as_algorithm()
        sparse_t = 3
        if isa_av.name == "sparse_isa":
            sparse_t = int(isa_av.options.get("t", "3"))
        return TextDS(
            text,
            device=self.env.registry.device,
            lcp_provider=lcp_av.name,
            isa_provider=isa_av.name,
            sparse_isa_t=sparse_t,
            compress_mode=self.env.option("cm").as_string(),
        )


def make_textds(compressor, text):
    """Build the TextDS for a compressor, honoring its `textds` option when
    declared (compressors without the axis get the defaults)."""
    env = compressor.env
    if env.has_option("textds"):
        algo = compressor.env.instantiate("textds")
        return algo.create(text)
    from .textds import TextDS

    return TextDS(text, device=env.registry.device)


def register(registry):
    for cls in (
        SADivSufSort,
        PhiFromSA,
        PLCPFromPhi,
        LCPFromPLCP,
        CompressedLCPProvider,
        ISAFromSA,
        SparseISAProvider,
        TextDSAlgo,
    ):
        registry.register(cls)
