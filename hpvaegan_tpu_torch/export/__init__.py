"""Export and native serving of the random-mode sampler (the port of the JAX
package's `export/`): `serving.py` builds and exports the serving program,
`python -m hpvaegan_tpu_torch.export` is the export CLI."""
