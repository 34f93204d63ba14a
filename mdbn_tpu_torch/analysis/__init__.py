"""Downstream analysis of latent codes: clustering, consensus, survival."""
