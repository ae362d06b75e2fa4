"""The port's multi-device machinery: the sharding rules
(``sharding.rules``), the collectives every sharded computation goes
through (``sharding.collectives``) and the GPipe pipeline
(``sharding.pipeline``)."""
