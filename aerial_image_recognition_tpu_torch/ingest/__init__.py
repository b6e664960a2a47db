"""The ingest plane: fetch → batch → prefetch → device."""
