"""Calculator adapters (ASE)."""
