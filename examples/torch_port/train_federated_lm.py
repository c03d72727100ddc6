"""End-to-end example on the PyTorch port: federated training of a
transformer LM with FedPBC under unreliable uplinks (the twin of
``examples/train_federated_lm.py``): data pipeline, round engine,
checkpointing.

A thin wrapper over the port's launcher, ``repro_torch.launch.train``, so
the example stays honest; every flag is the launcher's (``--device cpu``
runs it without a card):

  PYTHONPATH=src python examples/torch_port/train_federated_lm.py \\
      --arch smollm-135m --rounds 100 --clients 8 --scheme markov
"""
from repro_torch.launch.train import main

if __name__ == "__main__":
    main()
