"""Pipeline stages: the detection loop, hash and embedding dedup, box
post-filtering, grouping (clustering / classification).

Device compute (model forwards, NMS) lives in models/ and ops/; this package
is the host-side orchestration around it — video decode, filter/adjust/crop
business logic, file IO, CSV audit logs — arranged so host work overlaps
device work (prefetch decode, async writes).
"""
