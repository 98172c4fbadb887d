"""Γ storage on disk (``gamma_store``)."""
