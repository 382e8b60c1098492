"""The port's command-line tools (counterparts of the repo's `scripts/`):

    python -m ealdm_torch.scripts.sample_diffusion -r <logdir> [-n 50 -c 50 -e 1]
    python -m ealdm_torch.scripts.txt2img [--config <yaml>] [-r <logdir>] [--plms]
    python -m ealdm_torch.scripts.inpaint --outdir <dir> [--indir <dir>] [--tiny]
    python -m ealdm_torch.scripts.train_searcher -d <dir or .npz> -t <index.npz>
    python -m ealdm_torch.scripts.knn2img --database <npz> [--use_neighbors]
    python -m ealdm_torch.scripts.train_tokenizer [--vocab-size 12000] [--out PATH]
    python -m ealdm_torch.scripts.export_sampler -r <logdir> -o <artifact>

Each takes the JAX script's flags plus `--device` (default "cuda", which
raises without a card), builds its models in float32 as the JAX scripts do,
and exposes `main(argv)` for an in-process run.
"""
