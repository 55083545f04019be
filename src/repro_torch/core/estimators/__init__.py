"""Estimator implementations registered in the codec registry."""
