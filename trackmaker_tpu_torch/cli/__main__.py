from trackmaker_tpu_torch.cli.main import main

if __name__ == "__main__":
    main()
