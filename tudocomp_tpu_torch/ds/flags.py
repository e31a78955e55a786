"""Text data structure flags (mirror of ds/TextDSFlags.hpp). The port's copy
of tudocomp_tpu/ds/flags.py."""

SA = 1 << 0
ISA = 1 << 1
LCP = 1 << 2
PHI = 1 << 3
PLCP = 1 << 4
