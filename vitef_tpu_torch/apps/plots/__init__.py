"""The paper's tables and figures. Counterparts of ``apps/plots``: the run-dir
readers, tables and figures (``finetuning``, ``ablation``, ``analysis``), the
theoretical plasticity bounds (``theory``) and the loss-landscape surfaces
(``loss_landscape``). The two computations run on the card; rendering imports
matplotlib, seaborn, pandas and imageio inside the functions that draw or
build frames, so every module imports without them."""
