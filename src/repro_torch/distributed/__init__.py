"""Distributed pieces of the port.

Ported: serving across a model-axis mesh, tensor-parallel dense layers and
expert-parallel MoE (``sharding``: the reference's rules, ``AxisPlan``,
``plan_scope``, ``shard_params``; ``collectives``: all-reduce and
all-gather over an axis's process group; the mesh and the ranks' process
groups in ``launch/mesh.py``), and the int8 gradient compression with
error feedback (``compression``). Not ported (ROADMAP.md queue 1 item 9,
the data-axis slice): a data axis > 1 (data-parallel serving, FSDP / ZeRO-3
training shardings), sequence parallelism (``collectives.sp_scatter`` /
``sp_gather`` are no-ops without a ``seq`` axis), pipeline stages, elastic
re-meshing, and the SSM, hybrid, VLM and audio families under a mesh."""
