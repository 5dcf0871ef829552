"""Host utilities: feature gates."""
