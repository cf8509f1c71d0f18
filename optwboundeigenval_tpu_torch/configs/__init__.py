"""Config modules: ``options(**overrides) -> dict``."""
