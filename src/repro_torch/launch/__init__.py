"""Entry points: serving, the training launcher and meshes."""
