"""Host-side C++ of the port (the FLAC decoder and the resamplers), built
at first use by `native.build`."""
