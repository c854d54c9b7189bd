"""The test path's data layer: dataset catalogs, COCO parsing, the medical
registry, a PNG decoder, resizing and static-shape batching (host side,
NumPy)."""
