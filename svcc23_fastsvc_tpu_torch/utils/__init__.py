"""Host-side utilities: the feature scalers."""
