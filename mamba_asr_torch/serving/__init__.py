"""serving of the PyTorch port (see mamba_asr_torch/__init__.py).

The exported bundles' names (serving/export.py) are exported here, loaded
on first use: `serving.server`, the numpy-only client, imports this
package without PyTorch."""

__all__ = ["ExportedASR", "ExportedStreamingServer", "export_ctc_bundle",
           "export_s2s_bundle", "export_streaming_bundle"]


def __getattr__(name):
    if name in __all__:
        from mamba_asr_torch.serving import export

        return getattr(export, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
