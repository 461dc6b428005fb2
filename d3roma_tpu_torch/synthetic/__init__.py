from d3roma_tpu_torch.synthetic.procedural import (  # noqa: F401
    ProceduralSceneRenderer,
    SceneConfig,
    generate_dataset,
    generate_example_assets,
    generate_real_capture,
    write_hiss_frame,
)
