"""Eval-policy contract and the dreamer-family builder."""
