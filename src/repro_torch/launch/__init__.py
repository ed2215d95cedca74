"""Port of ``src/repro/launch``: device meshes, the serving launcher and the training launcher (the dry-run, report and roofline launchers wait, ROADMAP A16.3)."""
