"""Host-side utilities: the feature scalers, the job-array launcher,
metrics and the host C++ build."""
