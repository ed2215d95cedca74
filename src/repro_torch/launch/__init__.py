"""Port of ``src/repro/launch``: device meshes and the serving launcher (the train and dry-run launchers wait, ROADMAP A16)."""
