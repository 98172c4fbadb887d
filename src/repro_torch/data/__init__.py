"""Γ storage on disk (``gamma_store``) and the synthetic token stream
(``tokens``)."""
