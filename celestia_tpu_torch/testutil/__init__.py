"""Test harnesses (port of the JAX package's testutil): single-process
devnet, malicious apps, multi-validator network simulation, the IBC
coordinator (reference: test/util/testnode, test/util/malicious, test/e2e).

Imports stay inside the helpers, so importing the package pulls in no
state machine. ``testnode``'s App takes ``device`` among its keywords, and
the node runs on the App's device.
"""


def testnode(accounts: dict[str, int] | None = None, home: str | None = None,
             **app_kwargs):
    """Boot a single-validator in-process chain with the first (empty)
    block committed — the testnode.NewNetwork analogue
    (test/util/testnode/full_node.go:70)."""
    from celestia_tpu_torch.app import App
    from celestia_tpu_torch.node import Node

    app = App(**app_kwargs)
    app.init_chain(accounts or {}, genesis_time=0.0)
    node = Node(app, home=home)
    node.produce_block(15.0)
    return node


def funded_keys(n: int, amount: int = 10_000_000_000):
    """n deterministic keys + the genesis account map funding them."""
    from celestia_tpu_torch.crypto import PrivateKey

    keys = [PrivateKey.from_secret(f"testnode-{i}".encode()) for i in range(n)]
    return keys, {k.bech32_address(): amount for k in keys}
