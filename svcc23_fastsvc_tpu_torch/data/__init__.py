"""Host-side data: hdf5 dumps, datasets, batching and the wire format."""
