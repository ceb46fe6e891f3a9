"""Protocol constants the route build reads — the subset of
``openr_tpu.constants`` (the reference's common/Constants.h and MPLS
label ranges) that ``decision.spf_solver`` needs."""

# -- MPLS label ranges (reference MplsConstants)
MPLS_MIN_LABEL = 16
MPLS_MAX_LABEL = (1 << 20) - 1
