"""Host-side helpers: the COCO mask codec and the YAML reader."""
