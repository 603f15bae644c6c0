"""DART paper math on torch tensors: difficulty (Eqs. 1-8), thresholds
(Eqs. 10, 12, 19, Alg. 1), routing, the section II.C adaptation and the
section II.B policy search."""
