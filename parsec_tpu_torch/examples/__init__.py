"""The repo's runnable examples on the port, one module per script of
examples/ under the same stem, each run as

    python -m parsec_tpu_torch.examples.<stem> [arguments]

run_example compiles and runs a tutorial JDF (the .jdf files of
examples/, read as data); Ex09_PanelCholesky factors an SPD matrix as
tiles and as panels on a CudaDevice (the card by default, `--device
cpu` for the plain versions on the host); Ex10_CrossCheck runs a PTG
pool under the hwcounters PINS module and again through DTD.
"""
