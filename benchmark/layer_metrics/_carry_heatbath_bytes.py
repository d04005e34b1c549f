"""The bytes of one call of K3-hb (``ops/diag_carry.py``
``carry_decisions_heatbath``), counted as ``chip_smoke.py`` counts a
kernel's bytes for its bound: every argument and every result once, from
their shapes."""


def carry_heatbath_bytes(M: int, R: int) -> int:
    """``u0 f32[M, R]``, ``idp, dgp, insw bool[M, R]`` read; ``insert,
    remove bool[M, R]`` written; ``n0 i32[R]`` and ``bwt f32[R]`` read."""
    return M * R * (4 + 3 + 2) + 8 * R
